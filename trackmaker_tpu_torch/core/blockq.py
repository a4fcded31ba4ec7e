"""Two-level block index for "first set bit at or after a cursor" queries
(counterpart of ``trackmaker_tpu/core/blockq.py``).

A bool mask over a capture is cut into 512-wide blocks.  A query reads
the cursor's own block, then the next block holding a set bit.  Batched
here over captures and over cursors; the decisions are the JAX package's,
including its clip of the cursor to the last padded position.
"""

from __future__ import annotations

import torch

BIG = 2**30
BLK = 512


def block_tables(mask: torch.Tensor):
    """mask bool[B, T] -> (blocks bool[B, HB, BLK], any bool[B, HB])."""
    b, t = mask.shape
    hb = -(-t // BLK)
    blocks = torch.nn.functional.pad(mask, (0, hb * BLK - t)).reshape(b, hb, BLK)
    return blocks, blocks.any(-1)


def first_set_from(tables, cursor: torch.Tensor):
    """(first index >= cursor whose bit is set, exists), each [B, N], for
    cursors int[B, N]; 2^30 where none exists.

    The cursor is clipped to [0, HB·BLK - 1] first, as the JAX package does:
    a cursor past the end still reads the last position of the last block,
    which is a real sample when T is a multiple of BLK."""
    blocks, block_any = tables
    b, hb, _ = blocks.shape
    dev = blocks.device
    lane = torch.arange(BLK, dtype=torch.int32, device=dev)
    c = cursor.to(torch.int64).clamp(0, hb * BLK - 1)
    jb = c // BLK
    off = c % BLK
    row = blocks.gather(1, jb[..., None].expand(b, jb.shape[1], BLK))
    m1 = row & (lane >= off[..., None])
    i1 = jb * BLK + torch.where(m1, lane, BLK).amin(-1)
    has1 = m1.any(-1)
    # the first set lane of each block, and the next block at or after each
    # block that holds a set bit (hb where none)
    first_lane = torch.where(blocks, lane, BLK).amin(-1)                   # [B, HB]
    bidx = torch.arange(hb, dtype=torch.int64, device=dev)
    nxt = torch.where(block_any, bidx, hb).flip(-1).cummin(-1).values.flip(-1)
    nxt = torch.nn.functional.pad(nxt, (0, 1), value=hb)                   # [B, HB+1]
    b2 = nxt.gather(1, jb + 1)
    has2 = b2 < hb
    lane2 = torch.nn.functional.pad(first_lane, (0, 1)).gather(1, b2)
    i2 = b2 * BLK + lane2
    first = torch.where(has1, i1, torch.where(has2, i2, BIG))
    return first.to(torch.int32), has1 | has2
