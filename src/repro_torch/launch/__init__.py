"""Entry points of the port (the reference's ``repro.launch``): the
training launcher (``train``), the serving launcher (``serve``), the
production meshes (``mesh``) and the H100 dry run over the 40 cells
(``dryrun``, with ``roofline.analysis`` reading its records)."""
