"""Late materialization for join chains: deferred build-side gathers.

Port of presto_tpu/exec/latemat.py (reference: presto-spi
spi/block/DictionaryBlock.java — joins emit DictionaryBlocks over the
build-side PagesIndex, positions plus a shared values block, so carried
columns are never copied per operator; values materialize once, at the
first consumer that needs them). On the card a join chain is gather
bound: every carried build column costs one gather per join. Late
materialization replaces the per-join value gathers with ONE int64
row-id indirection column per build side:

  - a join emits its probe columns plus one id Block (build row per
    output row) instead of gathering every carried build column;
  - a downstream join gathers the id column like any probe column, so
    N chained joins COMPOSE the indirection into one id column per
    build side (ids' = ids[probe_idx]: one gather per side per join,
    however many columns the side carries);
  - join keys a downstream join needs are lifted (gathered) eagerly,
    one column each (``lift_page``);
  - everything else gathers exactly once, at the chain boundary
    (``finish_page``) — the first consumer that needs values.

The executor drives this through ``LazyPage`` items (exec/executor.py
``_lazy_pages`` / ``_join_pass(defer=...)``); pages leaving the join
subtree are always fully materialized, so every other operator is
untouched. ``Block.take`` (page.py) is the shared indirection
primitive.

Physical layout of ``LazyPage.reduced``: the materialized logical
channels in ascending logical order, then ONE id Block per deferred
side (side i at position ``len(mat) + i``). An id Block's ``nulls``
marks rows whose build side is SQL NULL (left-join padding); value
materialization ORs it over the gathered build nulls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from presto_tpu_torch.page import Page


@dataclasses.dataclass
class LazySide:
    """One deferred build side: the retained build page plus the map
    from logical output channels to build channels."""

    build: Page
    channel_map: Tuple[Tuple[int, int], ...]  # (logical channel, build ch)


@dataclasses.dataclass
class LazyPage:
    """A join output page with deferred build sides (see module doc)."""

    reduced: Page
    width: int  # logical channel count of the node's output
    mat: Tuple[int, ...]  # materialized logical channels, ascending
    sides: Tuple[LazySide, ...]

    def phys(self, channel: int) -> int:
        """Physical position of a MATERIALIZED logical channel."""
        return self.mat.index(channel)


def lift_layout(mat, maps, need):
    """Static recipe shared by ``lift_page`` and the executor's host
    bookkeeping: materializing ``need`` moves those channels into the
    sorted mat set and drops them (and empty sides) from the deferred
    maps. Returns (need, new_mat, new_maps, surviving side indices)."""
    need = tuple(sorted(set(need) - set(mat)))
    new_mat = tuple(sorted(set(mat) | set(need)))
    new_maps = tuple(
        tuple(pair for pair in m if pair[0] not in need) for m in maps
    )
    keep = tuple(i for i, m in enumerate(new_maps) if m)
    return need, new_mat, new_maps, keep


def _side_ids(id_block, build) -> torch.Tensor:
    return id_block.data.to(torch.int64).clamp(0, build.capacity - 1)


def lift_page(mat, maps, need, reduced: Page, *builds) -> Page:
    """Materialize the ``need`` channels (one gather each) and re-emit
    the reduced page in lift_layout order: downstream join keys and
    filter-referenced channels, the liveness-driven eager subset."""
    need, new_mat, new_maps, keep = lift_layout(mat, maps, need)
    nm = len(mat)
    got = {}
    for si, (m, build) in enumerate(zip(maps, builds)):
        id_block = reduced.blocks[nm + si]
        wanted = [pair for pair in m if pair[0] in need]
        if not wanted:
            continue
        ids = _side_ids(id_block, build)
        for oc, bc in wanted:
            got[oc] = build.blocks[bc].take(ids,
                                            extra_nulls=id_block.nulls)
    blocks = []
    for c in new_mat:
        if c in got:
            blocks.append(got[c])
        else:
            blocks.append(reduced.blocks[mat.index(c)])
    for si in keep:
        blocks.append(reduced.blocks[nm + si])
    return Page(blocks=tuple(blocks), valid=reduced.valid)


def finish_page(mat, maps, width, reduced: Page, *builds) -> Page:
    """Full materialization at the chain boundary: every deferred
    column gathers exactly ONCE through its side's composed id column;
    materialized channels pass through."""
    blocks = [None] * width
    for i, c in enumerate(mat):
        blocks[c] = reduced.blocks[i]
    nm = len(mat)
    for si, (m, build) in enumerate(zip(maps, builds)):
        id_block = reduced.blocks[nm + si]
        ids = _side_ids(id_block, build)
        for oc, bc in m:
            blocks[oc] = build.blocks[bc].take(ids,
                                               extra_nulls=id_block.nulls)
    if any(b is None for b in blocks):
        raise ValueError("a lazy page left a logical channel unset")
    return Page(blocks=tuple(blocks), valid=reduced.valid)
