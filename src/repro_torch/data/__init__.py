"""Synthetic corpora (numpy-seeded, identical to the reference)."""
