"""Shape helpers shared by the port."""
