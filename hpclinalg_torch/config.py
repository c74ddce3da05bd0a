"""Global layout constants.

Only the padding granularity survives from the JAX package's configuration:
there is no compile cache and no route cache to configure on PyTorch.
"""

from __future__ import annotations

# Padding granularity of the trailing dimension of padded local shards.
# Kept equal to the JAX package's value so both packages lay out the same
# (S, L) stacked shards and their plans can be compared slot for slot.
PAD_MULTIPLE = 8


def round_up(n: int, m: int = PAD_MULTIPLE) -> int:
    """Round ``n`` up to a multiple of ``m`` (always at least ``m``)."""
    if n <= 0:
        return m
    return ((n + m - 1) // m) * m
