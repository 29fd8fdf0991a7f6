"""Training of the port (the reference's ``repro.train``): AdamW, the
fault-tolerant trainer and gradient compression."""
