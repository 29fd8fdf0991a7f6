"""Entry points of the port (the reference's ``repro.launch``): the
training launcher (``train``) and the serving launcher (``serve``).
``dryrun``, ``mesh`` and the roofline wait for ROADMAP.md Queue 1 Step
12's H100 roofline and Step 11's mesh."""
