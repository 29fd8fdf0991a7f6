"""The equivariant library of the port (the reference's
``repro.equivariant``): real spherical harmonics and real-basis Wigner-D
blocks (``spherical``), Clebsch–Gordan coupling tensors (``cg``) and
DimeNet's Bessel bases (``bessel``)."""
