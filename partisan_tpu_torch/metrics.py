"""Device-resident metrics plane: per-round, per-channel and per-cause
counters written by the round (port of ``partisan_tpu/metrics.py``).

A ring of ``Config.metrics_ring`` rounds carried in ``ClusterState``;
slot ``rnd % ring`` holds round ``rnd`` (the slot is a device scalar, so
writing the ring needs no host read), decoded on the host after a batch
of rounds.  ``Config.metrics=False`` keeps the leaf ``()``.

Cause taxonomy (trailing axis of ``MetricsState.drops``): the event
lane's per-round ``emitted - delivered`` delta broken out by where the
message died — emission compaction overflow, the fault masks, receiver
inbox overflow, crash-stopped receivers, channel-capacity outbox sheds,
the ingress lane's sheds (requests shed at a full buffer or a dead
source, counted as emitted and dropped) and the residual
``other`` (defer/release imbalance of the channel-capacity stage, which
may be negative in a round and telescopes over a window).  By
construction ``drops.sum(-1)`` equals the round's ``Stats.dropped``
delta.  Monotonic-channel sheds are the separate ``shed`` series: they
are excluded from ``emitted``.

Counts use ``scatter_add`` of int32 ones onto ``C`` channel bins: integer
addition is order-free, so the card's atomics give the CPU's numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import types as T

CAUSE_COMPACT = 0
CAUSE_FAULT = 1
CAUSE_INBOX = 2
CAUSE_DEAD = 3
CAUSE_OUTBOX = 4
CAUSE_INGRESS = 5
CAUSE_OTHER = 6
N_CAUSES = 7
CAUSE_NAMES = ("compact_shed", "fault_cut", "inbox_overflow",
               "dead_receiver", "outbox_shed", "ingress_shed", "other")

_I32 = torch.int32
_BIG = 2 ** 30


class MetricsState(NamedTuple):
    """Ring of per-round counters, all int32 (``R`` = metrics_ring,
    ``C`` = n_channels); ``rnd[slot] == -1`` marks a slot never
    written."""

    rnd: torch.Tensor           # int32[R]
    emitted: torch.Tensor       # int32[R, C]
    delivered: torch.Tensor     # int32[R, C] — event-lane deliveries
    causal: torch.Tensor        # int32[R] — causal-lane deliveries
    shed: torch.Tensor          # int32[R] — monotonic-channel sheds
    drops: torch.Tensor         # int32[R, N_CAUSES]
    inbox_hwm: torch.Tensor     # int32[R] — max inbox occupancy
    inbox_occ: torch.Tensor     # int32[R] — total inbox occupancy
    edges_total: torch.Tensor   # int32[R] — live overlay out-edges
    edges_min: torch.Tensor     # int32[R] — min over alive nodes
    edges_max: torch.Tensor     # int32[R]
    alive: torch.Tensor         # int32[R]
    dlv_overflow: torch.Tensor  # int32[R] — delivery-plane drop delta


def enabled(cfg) -> bool:
    return cfg.metrics


def init(cfg, comm) -> MetricsState:
    R, C, dev = cfg.metrics_ring, cfg.n_channels, comm.device

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    return MetricsState(
        rnd=torch.full((R,), -1, dtype=_I32, device=dev),
        emitted=z(R, C), delivered=z(R, C), causal=z(R), shed=z(R),
        drops=z(R, N_CAUSES), inbox_hwm=z(R), inbox_occ=z(R),
        edges_total=z(R), edges_min=z(R), edges_max=z(R), alive=z(R),
        dlv_overflow=z(R))


def bin_count(idx: torch.Tensor, mask: torch.Tensor, bins: int
              ) -> torch.Tensor:
    """int32[bins]: how many of the ``mask``-selected entries of ``idx``
    (values in [0, bins)) fall in each bin — an integer scatter-add, the
    same on every device."""
    flat = idx.reshape(-1).to(torch.int64)
    ones = mask.reshape(-1).to(_I32)
    # ``new_zeros`` of the counted tensor: batched in a fleet round
    return ones.new_zeros(bins).scatter_add_(0, flat, ones)


def channel_counts(cfg, msgs, mask: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """int32[C]: live records of ``msgs`` (planes) by channel, restricted
    to ``mask`` when given."""
    valid = msgs[T.W_KIND] != 0
    if mask is not None:
        valid = valid & mask
    ch = msgs[T.W_CHANNEL].to(_I32).clamp(0, cfg.n_channels - 1)
    return bin_count(ch, valid, cfg.n_channels)


def put(ring: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """``ring.at[slot].set(value)`` with a device-scalar slot: a new
    tensor, the input untouched, no host read."""
    if isinstance(value, torch.Tensor):
        v = value.to(ring.dtype)
    else:   # a Python number: a fill, not a host->card copy
        v = torch.full((), value, dtype=ring.dtype, device=ring.device)
    return ring.index_copy(0, slot.reshape(1).to(torch.int64),
                           v.expand(ring.shape[1:]).unsqueeze(0))


def record_round(cfg, comm, ms: MetricsState, *, rnd, emitted_ch,
                 delivered_ch, causal, shed, drops, inbox_count,
                 alive_local, alive_global, nbrs, dlv_overflow
                 ) -> MetricsState:
    """Write one round's counters into ring slot ``rnd % R``.
    ``alive_local``/``alive_global`` arrive masked by the active prefix
    under ``Config.width_operand``."""
    slot = torch.remainder(rnd, cfg.metrics_ring)
    # inbox_count, nbrs and alive_local are this shard's rows: every
    # value is reduced across shards before it is written
    occ = comm.allsum(inbox_count.sum().to(_I32))
    hwm = comm.allmax(inbox_count.max().to(_I32))
    # an edge is live only if both endpoints are alive
    live_nbr = (nbrs >= 0) & alive_global[
        nbrs.clamp(0, cfg.n_nodes - 1).to(torch.int64)]
    e = live_nbr.sum(dim=1).to(_I32)
    e = torch.where(alive_local, e, 0)
    n_alive = comm.allsum(alive_local.sum().to(_I32))
    e_total = comm.allsum(e.sum().to(_I32))
    e_max = comm.allmax(e.max())
    # min over alive nodes only; an all-dead cluster reports 0
    e_min = torch.where(
        n_alive > 0,
        -comm.allmax(torch.where(alive_local, -e, -_BIG).max()),
        0).to(_I32)
    return MetricsState(
        rnd=put(ms.rnd, slot, rnd),
        emitted=put(ms.emitted, slot, emitted_ch),
        delivered=put(ms.delivered, slot, delivered_ch),
        causal=put(ms.causal, slot, causal),
        shed=put(ms.shed, slot, shed),
        drops=put(ms.drops, slot, drops),
        inbox_hwm=put(ms.inbox_hwm, slot, hwm),
        inbox_occ=put(ms.inbox_occ, slot, occ),
        edges_total=put(ms.edges_total, slot, e_total),
        edges_min=put(ms.edges_min, slot, e_min),
        edges_max=put(ms.edges_max, slot, e_max),
        alive=put(ms.alive, slot, n_alive),
        dlv_overflow=put(ms.dlv_overflow, slot, dlv_overflow))


# ---------------------------------------------------------------------------
# Host-side readers
# ---------------------------------------------------------------------------

_SERIES = ("emitted", "delivered", "causal", "shed", "drops",
           "inbox_hwm", "inbox_occ", "edges_total", "edges_min",
           "edges_max", "alive", "dlv_overflow")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def ring_order(rnd) -> np.ndarray:
    """Slot order of a ring's round labels (-1 = never written) that
    yields rounds ascending; shared by every ring of the planes."""
    rnd = _host(rnd)
    keep = np.flatnonzero(rnd >= 0)
    return keep[np.argsort(rnd[keep], kind="stable")]


def snapshot(ms: MetricsState) -> dict:
    """``{"rounds": [k], <series>: [k, ...]}`` ordered by round, k <=
    metrics_ring (one device->host copy per series, after the run)."""
    rnd = _host(ms.rnd)
    idx = ring_order(rnd)
    out: dict = {"rounds": rnd[idx]}
    for name in _SERIES:
        out[name] = _host(getattr(ms, name))[idx]
    return out


def rows(snap: dict, channels: tuple | None = None) -> list[dict]:
    """One JSON-ready dict per round, channel and cause axes labeled."""
    C = snap["emitted"].shape[1] if len(snap["emitted"]) else 0
    ch_names = tuple(channels) if channels is not None \
        else tuple(f"ch{i}" for i in range(C))
    out = []
    for i, r in enumerate(snap["rounds"]):
        out.append({
            "round": int(r),
            "emitted": {ch_names[c]: int(snap["emitted"][i, c])
                        for c in range(C)},
            "delivered": {ch_names[c]: int(snap["delivered"][i, c])
                          for c in range(C)},
            "causal_delivered": int(snap["causal"][i]),
            "shed": int(snap["shed"][i]),
            "drops": {CAUSE_NAMES[j]: int(snap["drops"][i, j])
                      for j in range(N_CAUSES)},
            "inbox_hwm": int(snap["inbox_hwm"][i]),
            "inbox_occupancy": int(snap["inbox_occ"][i]),
            "edges": {"total": int(snap["edges_total"][i]),
                      "min": int(snap["edges_min"][i]),
                      "max": int(snap["edges_max"][i])},
            "alive": int(snap["alive"][i]),
            "delivery_overflow": int(snap["dlv_overflow"][i]),
        })
    return out


def totals(snap: dict) -> dict:
    """Whole-window aggregates, the reconciliation view against the
    cumulative ``Stats`` (equal when the run fits the ring)."""
    return {
        "rounds": int(len(snap["rounds"])),
        "emitted": int(snap["emitted"].sum()),
        "delivered": int(snap["delivered"].sum())
        + int(snap["causal"].sum()),
        "dropped": int(snap["drops"].sum()),
        "shed": int(snap["shed"].sum()),
        "drops_by_cause": {
            CAUSE_NAMES[j]: int(snap["drops"][:, j].sum())
            for j in range(N_CAUSES)},
    }
