"""The H100 roofline of the port (the reference's ``repro.roofline``):
``trace`` counts a step's work from its dispatch trace (the counterpart of
``hlo_parse``), ``analysis`` turns a dry-run record into compute, memory
and collective terms at the H100's peaks."""
