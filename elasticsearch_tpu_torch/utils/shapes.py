"""Shape bucketing helpers (copy of ``elasticsearch_tpu/utils/shapes.py``).

The serving plane rounds ragged query shapes (term count, postings run
length) up to a small lattice of buckets; the port keeps the same buckets
so its packed plane and its launch shapes match the reference's.
"""

from __future__ import annotations


def round_up_pow2(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def round_up_multiple(n: int, multiple: int) -> int:
    return ((int(n) + multiple - 1) // multiple) * multiple


def bucket_length(n: int, minimum: int = 8, maximum: int | None = None) -> int:
    b = round_up_pow2(n, minimum)
    if maximum is not None:
        b = min(b, maximum)
    return b
