"""Runtime hooks of the port (the reference's ``repro.runtime``)."""
