"""Entry points of the port (the reference's ``repro.launch``): the
training launcher (``train``), the serving launcher (``serve``) and the
production meshes (``mesh``). ``dryrun`` and the roofline wait for
ROADMAP.md Queue 1 Step 12's H100 roofline."""
