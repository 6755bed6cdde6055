"""The (dp, sp) grid of ranks for the tile-sharded encode and decode.

Port of go_jpeg2000_tpu/parallel/mesh.py `make_mesh` onto torch.distributed:
'dp' ranks hold disjoint sets of tiles, and the 'sp' ranks of one dp shard
hold disjoint row shards of the same tiles and exchange DWT halo rows.  The
ranks of a group form a dp x sp array in rank order, as make_mesh lays out
its devices.  Without a group the grid is one process: dp = sp = 1, and no
collective runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist


@dataclasses.dataclass
class Grid:
    dp: int
    sp: int
    dp_rank: int = 0               # this rank's tile shard
    sp_rank: int = 0               # this rank's row shard
    group: object = None           # every rank of the grid (None: one process)
    dp_group: object = None        # this rank's sp column across the dp shards
    sp_group: object = None        # the sp ranks of this rank's dp shard

    @property
    def size(self) -> int:
        return self.dp * self.sp


def make_grid(group=None, dp: Optional[int] = None,
              sp: Optional[int] = None) -> Grid:
    """Split `group` (a torch.distributed process group, WORLD for the
    default one) into dp tile shards x sp row shards.  Default split, as
    make_mesh's: sp = 2 when the group has an even size of at least 4, else
    sp = 1.  Every rank of the default group must call this (it creates the
    dp and sp subgroups).  group=None: one process, dp = sp = 1."""
    if group is None:
        if (dp or 1) != 1 or (sp or 1) != 1:
            raise ValueError("a grid without a process group has dp = sp = 1")
        return Grid(1, 1)
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    if dp is None or sp is None:
        if n >= 4 and n % 2 == 0:
            sp = sp or 2
            dp = dp or n // sp
        else:
            dp, sp = n, 1
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} ranks")
    me = ranks.index(dist.get_rank())
    grid = Grid(dp, sp, me // sp, me % sp, group)
    for d in range(dp):
        peers = ranks[d * sp:(d + 1) * sp]
        g = dist.new_group(peers)
        if d == grid.dp_rank:
            grid.sp_group = g
    for s in range(sp):
        g = dist.new_group(ranks[s::sp])
        if s == grid.sp_rank:
            grid.dp_group = g
    return grid
