"""Training of the port (the reference's ``repro.train``): AdamW and the
fault-tolerant trainer."""
