"""Shared small helpers."""

__all__ = ["pow2_at_least", "round_up"]


def round_up(x, m):
    """Smallest multiple of ``m`` >= ``x``: the alignment rule of the
    chain geometry (halos, lead and tail are whole 128-sample frames)."""
    return -(-int(x) // int(m)) * int(m)


def pow2_at_least(n):
    """Smallest power of two >= ``n`` (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1
