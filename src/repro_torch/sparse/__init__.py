"""Segment primitives of the port (the reference's ``repro.sparse``)."""
