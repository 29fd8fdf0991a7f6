"""Shape-rounding helpers.

``pow2_round`` quantises a data-dependent width (a filter's scan width, a
drain size) to O(log n) distinct values; ``pad_to_chunk`` rounds up to a
chunk multiple. The port runs eagerly, so these no longer bound a compile
cache; they keep the reference's widths, so both packages scan the same
candidate sets."""
from __future__ import annotations


def pow2_round(n: int, *, lo: int = 1, hi: int | None = None) -> int:
    """Smallest power of two >= n, clamped to [lo, hi].

    The executor's oversample loop doubles its scan width from here, as
    the reference does, so both packages scan the same widths."""
    n = max(int(n), 1)
    v = 1 << (n - 1).bit_length()
    v = max(v, lo)
    if hi is not None:
        v = min(v, hi)
    return v


def pad_to_chunk(n: int, chunk: int) -> int:
    """Smallest multiple of ``chunk`` >= n (n=0 stays 0)."""
    chunk = int(chunk)
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n = int(n)
    return ((n + chunk - 1) // chunk) * chunk
