"""The per-round message exchange: route emitted records into inboxes.

Port of ``partisan_tpu/ops/exchange.py``.  ``route`` flattens the
emission stack, stable-sorts it by destination (per-sender emission
order survives — the per-connection FIFO analogue), finds each
destination's run with a binary search and gathers up to ``cap``
records per destination; the rest count as drops.  Records stay planes
throughout (one sort on the destination plane, per-plane gathers).
``merge_inboxes`` appends one inbox's records after another's (the
causal lanes' deliveries into the event inbox).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.types import W_DST, W_KIND


class Inbox(NamedTuple):
    data: plane_ops.Planes  # [n, cap] records; kind == 0 marks empty slots
    count: torch.Tensor     # int32[n] — valid slots per node
    drops: torch.Tensor     # int32[n] — messages dropped for this node


def empty_inbox(n: int, cap: int, layout: Sequence, device=None) -> Inbox:
    """``layout``: the per-word storage dtypes (``Config.wire_layout``)."""
    return Inbox(
        data=plane_ops.zero_planes((n, cap), tuple(layout), device=device),
        count=torch.zeros(n, dtype=torch.int32, device=device),
        drops=torch.zeros(n, dtype=torch.int32, device=device))


def route(emitted: plane_ops.Planes, n: int, cap: int,
          node_offset: int = 0) -> Inbox:
    """Route ``[m, E]`` records into an n-node inbox of ``cap`` slots.
    ``node_offset`` is the global id of inbox row 0: destinations outside
    ``[node_offset, node_offset + n)`` are ignored (a shard routing the
    gathered emissions into its own node range)."""
    flat = emitted.map(lambda w: w.reshape(-1))
    dev = flat[0].device
    m = flat[0].shape[0]
    kind = flat[W_KIND]
    dst = flat[W_DST] if node_offset == 0 else flat[W_DST] - node_offset
    local = (kind != 0) & (dst >= 0) & (dst < n)
    dst = torch.where(local, dst, n)

    order = torch.sort(dst, stable=True)[1]
    dst_sorted = dst[order]
    bounds = torch.searchsorted(
        dst_sorted, torch.arange(n + 2, dtype=dst.dtype, device=dev))
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)      # [n+1]
    starts = bounds[:-1]                                     # [n+1]
    cap_idx = torch.arange(cap, dtype=torch.int64, device=dev)
    src_pos = (starts[:n, None] + cap_idx[None, :]).clamp(0, m - 1)
    valid = cap_idx[None, :] < counts[:n, None]
    take = torch.where(valid, order[src_pos], m)
    data = plane_ops.take_flat(flat, take, fill=True)
    delivered = torch.minimum(counts[:n], torch.tensor(
        cap, dtype=torch.int32, device=dev))
    return Inbox(data=data, count=delivered, drops=counts[:n] - delivered)


def compact_emissions(emitted: plane_ops.Planes, cap: int
                      ) -> plane_ops.Planes:
    """Shrink ``[n, E]`` records to ``[n, cap]``: a stable per-row
    compaction keeping up to ``cap`` live records in emission order."""
    n, E = emitted[W_KIND].shape
    if cap >= E:
        return emitted
    valid = emitted[W_KIND] != 0
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True)[1]
    take = order[:, :cap]
    keep = torch.arange(cap, device=valid.device)[None, :] < \
        valid.sum(dim=1)[:, None]
    return plane_ops.take_rows(emitted, torch.where(keep, take, E),
                               fill=True)


def merge_inboxes(a: Inbox, b: Inbox) -> Inbox:
    """Append b's records after a's, capacity permitting: each row's
    valid slots of both float to the front in order (the stable
    compaction), the first ``cap`` kept.  ``b`` has at least one slot,
    any number, and need not be compacted; the result keeps a's capacity
    and layout."""
    cap = a.data[W_KIND].shape[1]
    data = compact_emissions(plane_ops.concat([a.data, b.data], dim=1), cap)
    total = a.count + b.count
    delivered = total.clamp(max=cap)
    return Inbox(data=data, count=delivered,
                 drops=a.drops + b.drops + total - delivered)
