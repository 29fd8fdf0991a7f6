"""Entry points of the port (the reference's ``repro.launch``): the
training launcher. ``serve``, ``dryrun``, ``mesh`` and the roofline wait
for ROADMAP.md Queue 1 Step 12."""
