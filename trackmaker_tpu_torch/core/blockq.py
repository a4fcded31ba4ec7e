"""First set bit at or after a cursor, for many cursors over one mask
(counterpart of ``trackmaker_tpu/core/blockq.py``).

The JAX package answers these queries from a two-level index of 512-wide
blocks, which keeps each query to one row gather on a TPU.  Here one
reverse running minimum builds, once a mask, the first set position at or
after every position of the mask zero-padded to whole blocks, and a query
is one gather.  Batched over captures and over cursors; the decisions are
the JAX package's, including its clip of the cursor to the last padded
position.
"""

from __future__ import annotations

import torch

BIG = 2**30
BLK = 512


def block_tables(mask: torch.Tensor) -> torch.Tensor:
    """mask bool[B, T] -> int32[B, HB·BLK], HB = ceil(T / BLK): the first
    set position at or after each position of the mask zero-padded to whole
    blocks, BIG where none."""
    b, t = mask.shape
    n = -(-t // BLK) * BLK
    pos = torch.arange(n, dtype=torch.int32, device=mask.device)
    padded = torch.nn.functional.pad(mask, (0, n - t))
    return torch.where(padded, pos, BIG).flip(-1).cummin(-1).values.flip(-1)


def first_set_from(table: torch.Tensor, cursor: torch.Tensor):
    """(first index >= cursor whose bit is set, exists), each [B, N], for
    cursors int[B, N] and the table of :func:`block_tables`; 2^30 where
    none exists.

    The cursor is clipped to [0, HB·BLK - 1] first, as the JAX package does:
    a cursor past the end still reads the last position of the last block,
    which is a real sample when T is a multiple of BLK."""
    first = table.gather(1, cursor.to(torch.int64).clamp(0, table.shape[1] - 1))
    return first, first < BIG
