"""Selection-mask materialization: compact valid rows to a dense prefix
and gather rows by index.

Port of presto_tpu/ops/compact.py. Compaction is one stable argsort of
the validity mask plus output-sized gathers — no host sync, so the row
count never leaves the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from presto_tpu_torch.ops import consts
from presto_tpu_torch.page import Block, Dictionary, Page


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def compact_page(page: Page, out_capacity: Optional[int] = None) -> Page:
    """Valid rows move to a dense prefix, original order kept. Rows past
    out_capacity are dropped — callers that can overflow check
    num_rows first."""
    cap_out = out_capacity or page.capacity
    n = page.capacity
    order = torch.argsort((~page.valid).to(torch.uint8), stable=True)
    num = page.num_rows()
    if cap_out <= n:
        src = order[:cap_out]
    else:
        src = torch.cat([order, order.new_zeros(cap_out - n)])
    out_valid = _arange(cap_out, page.device) < num
    new_blocks = []
    for blk in page.blocks:
        if isinstance(blk.data, tuple):
            data = tuple(d[src] for d in blk.data)
        else:
            data = blk.data[src]
        nulls = blk.nulls[src] if blk.nulls is not None else None
        new_blocks.append(blk.with_data(data, nulls=nulls))
    return Page(blocks=tuple(new_blocks), valid=out_valid)


def gather_rows(
    page: Page,
    indices: torch.Tensor,
    valid: torch.Tensor,
    *,
    force_null: Optional[torch.Tensor] = None,
) -> Page:
    """Row gather: output row j = input row indices[j] (valid[j] gates).
    force_null marks gathered rows entirely NULL (outer-join padding)."""
    idx = indices.clamp(0, page.capacity - 1)
    new_blocks = [
        blk.take(idx, extra_nulls=force_null) for blk in page.blocks
    ]
    return Page(blocks=tuple(new_blocks), valid=valid)


def concat_all(pages) -> Page:
    """n-way page concat with dictionary reconciliation: differing
    dictionaries merge through one value universe and codes remap via
    host luts."""
    pages = list(pages)
    if len(pages) == 1:
        return pages[0]
    blocks = []
    for ch in range(pages[0].channel_count):
        blks = [p.block(ch) for p in pages]
        dic = None
        datas = [b.data for b in blks]
        if any(b.dictionary is not None for b in blks):
            dics = [b.dictionary for b in blks]
            if all(d == dics[0] for d in dics):
                dic = dics[0]
            else:
                pos = {}
                for d in dics:
                    for v in (d.values if d is not None else []):
                        pos.setdefault(v, len(pos))
                dic = Dictionary(list(pos))
                remapped = []
                for b, d in zip(blks, dics):
                    if d is None or len(d) == 0:
                        remapped.append(torch.zeros_like(b.data))
                        continue
                    lut = np.array([pos[v] for v in d.values], np.int32)
                    codes = b.data.clamp(0, len(d) - 1).to(torch.int64)
                    remapped.append(
                        consts.lut(lut, b.data.device)[codes])
                datas = remapped
        if isinstance(datas[0], tuple):
            data = tuple(
                torch.cat([d[i] for d in datas])
                for i in range(len(datas[0]))
            )
        else:
            data = torch.cat(datas)
        if all(b.nulls is None for b in blks):
            nulls = None
        else:
            nulls = torch.cat([b.nulls_or_false() for b in blks])
        blocks.append(
            Block(data=data, type=blks[0].type, nulls=nulls, dictionary=dic)
        )
    valid = torch.cat([p.valid for p in pages])
    return Page(blocks=tuple(blocks), valid=valid)


def slice_page(page: Page, start: int, size: int) -> Page:
    """Static row-window slice [start, start+size) of a page."""
    stop = min(start + size, page.capacity)
    blocks = []
    for blk in page.blocks:
        data = (
            tuple(d[start:stop] for d in blk.data)
            if isinstance(blk.data, tuple) else blk.data[start:stop]
        )
        nulls = blk.nulls[start:stop] if blk.nulls is not None else None
        blocks.append(blk.with_data(data, nulls=nulls))
    return Page(blocks=tuple(blocks), valid=page.valid[start:stop])
