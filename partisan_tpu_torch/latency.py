"""Device-resident latency plane and flight recorder (port of
``partisan_tpu/latency.py``).

**Latency plane** (``Config(latency=True)``): every event-lane record
grows one trailing int32 word, its birth round, stamped at emission
(:func:`stamp`) and carried verbatim through every queued copy (the ack
store and causal rings, the channel-capacity outbox, the delay stage's
hold buffer, the inbox), so a retransmission or deferred release keeps
its original birth and ``deliver_round - birth_round`` is the true
end-to-end delay.  Ages go into per-channel log2 histograms, drops into
a drop-age histogram keyed by the metrics plane's causes.  The rows
``CAUSE_INBOX``, ``CAUSE_INGRESS`` and ``CAUSE_OTHER`` stay zero (an
inbox-overflow victim is never materialized per message; the residual is
what the round cannot see).

**Flight recorder** (``Config(flight_rounds=K)``): a ring of the last K
rounds' post-interposition wire stacks and fault-drop masks, written
through the interleave (the hand-written kernel on the card) on the
generic wire arm and decoded on the host into a ``trace.Trace``
(:func:`flight_trace`) equal to ``Cluster.record``'s capture of the same
rounds.

Histograms count with ``scatter_add`` onto ``channel * N_BUCKETS +
bucket`` (integer adds, order-free, no integer matmul, which CUDA does
not have); maxima are ``scatter_reduce("amax")``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import metrics as metrics_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.metrics import N_CAUSES
from partisan_tpu_torch.ops import plane as plane_ops

# Log2 age buckets: bucket 0 holds age 0, bucket k in [1, N_BUCKETS-2]
# ages [2^(k-1), 2^k - 1], the last everything older (the high-water
# mark keeps the exact maximum).  bucket = #{bounds <= age}.
N_BUCKETS = 12
BUCKET_BOUNDS = tuple(1 << k for k in range(N_BUCKETS - 1))   # 1..1024

_I32 = torch.int32


class LatencyState(NamedTuple):
    """Cumulative age histograms, all int32 (``C`` = n_channels)."""

    deliver: torch.Tensor   # int32[C, N_BUCKETS] — delivery ages
    drop_age: torch.Tensor  # int32[N_CAUSES, N_BUCKETS] — drop ages
    age_hwm: torch.Tensor   # int32[C] — max delivery age per channel


class FlightState(NamedTuple):
    """Ring of the last ``flight_rounds`` rounds' wire capture; slot
    ``rnd % K`` holds round ``rnd`` (-1 = never written)."""

    rnd: torch.Tensor      # int32[K]
    sent: torch.Tensor     # int32[K, n, E, W] — post-interposition wire
    dropped: torch.Tensor  # bool[K, n, E] — cleared by the fault stage


def enabled(cfg) -> bool:
    return cfg.latency


def flight_enabled(cfg) -> bool:
    return cfg.flight_rounds > 0


def init(cfg, device=None) -> LatencyState:
    C = cfg.n_channels
    return LatencyState(
        deliver=torch.zeros((C, N_BUCKETS), dtype=_I32, device=device),
        drop_age=torch.zeros((N_CAUSES, N_BUCKETS), dtype=_I32,
                             device=device),
        age_hwm=torch.zeros((C,), dtype=_I32, device=device))


def flight_init(cfg, sent_shape: tuple, device=None) -> FlightState:
    """Zero ring for a wire stack of shape ``(n, E, W)``."""
    K = cfg.flight_rounds
    n, E, W = sent_shape
    return FlightState(
        rnd=torch.full((K,), -1, dtype=_I32, device=device),
        sent=torch.zeros((K, n, E, W), dtype=_I32, device=device),
        dropped=torch.zeros((K, n, E), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Birth-round threading
# ---------------------------------------------------------------------------

def stamp(emitted: plane_ops.Planes, rnd: torch.Tensor) -> plane_ops.Planes:
    """Append the birth-round plane (int32, the current round in every
    slot) to a freshly emitted stack."""
    return plane_ops.append_words(emitted, rnd.to(_I32))


def stamp_fresh(cfg, msgs: plane_ops.Planes, rnd) -> plane_ops.Planes:
    """Set the birth word on control records built mid-round (acks,
    stream resets): they are born now.  Retransmit replays are not
    restamped.  No-op when the plane is off."""
    if not cfg.latency:
        return msgs
    return plane_ops.set_word(
        msgs, len(msgs) - 1,
        torch.where(msgs[T.W_KIND] != 0, torch.as_tensor(rnd), 0))


def ages(msgs: plane_ops.Planes, rnd) -> torch.Tensor:
    """int32[...]: ``rnd - birth`` per record (callers mask validity)."""
    return (torch.as_tensor(rnd) - msgs[-1]).clamp(min=0).to(_I32)


_BOUNDS: dict = {}


def bucket(age: torch.Tensor) -> torch.Tensor:
    """Log2 bucket index in [0, N_BUCKETS), integer-exact."""
    b = _BOUNDS.get(age.device)
    if b is None:
        b = _BOUNDS[age.device] = torch.tensor(BUCKET_BOUNDS, dtype=_I32,
                                               device=age.device)
    return torch.bucketize(age.to(_I32), b, out_int32=True, right=True)


def age_hist(msgs: plane_ops.Planes, mask: torch.Tensor, rnd
             ) -> torch.Tensor:
    """int32[N_BUCKETS]: age histogram of the ``mask``-selected
    records."""
    return metrics_mod.bin_count(bucket(ages(msgs, rnd)), mask, N_BUCKETS)


def channel_age_hist(cfg, msgs: plane_ops.Planes, mask: torch.Tensor, rnd
                     ) -> torch.Tensor:
    """int32[C, N_BUCKETS]: :func:`age_hist` split by ``W_CHANNEL``."""
    C = cfg.n_channels
    ch = msgs[T.W_CHANNEL].to(_I32).clamp(0, C - 1)
    key = ch * N_BUCKETS + bucket(ages(msgs, rnd))
    return metrics_mod.bin_count(key, mask, C * N_BUCKETS).reshape(
        C, N_BUCKETS)


def zero_hist(device=None) -> torch.Tensor:
    return torch.zeros((N_BUCKETS,), dtype=_I32, device=device)


def channel_age_max(cfg, msgs: plane_ops.Planes, mask: torch.Tensor, rnd
                    ) -> torch.Tensor:
    """int32[C]: max age among the ``mask``-selected records per channel
    (0 = floor).  Shared by :func:`record_round`'s high-water mark and
    the backpressure controller's sensor."""
    C = cfg.n_channels
    ch = msgs[T.W_CHANNEL].to(_I32).clamp(0, C - 1)
    a = torch.where(mask, ages(msgs, rnd), 0)
    return torch.zeros(C, dtype=_I32, device=a.device).scatter_reduce(
        0, ch.reshape(-1).to(torch.int64), a.reshape(-1), "amax",
        include_self=True)


def record_round(cfg, comm, ls: LatencyState, *, rnd, inbox_data, dead,
                 fault_hist, compact_hist, outbox_hist, chmax=None
                 ) -> LatencyState:
    """Accumulate one round's ages.  ``inbox_data`` is the routed inbox
    before the dead-receiver mask and ``dead`` its per-node mask;
    ``chmax``, when given, is the backpressure sensor's per-channel age
    maximum over the same inputs (computed once)."""
    from partisan_tpu_torch.metrics import (CAUSE_COMPACT, CAUSE_DEAD,
                                            CAUSE_FAULT, CAUSE_OUTBOX)

    live = inbox_data[T.W_KIND] != 0
    delivered = live & ~dead[:, None]
    # the histograms are this shard's: reduced before they accumulate
    dlv = comm.allsum(channel_age_hist(cfg, inbox_data, delivered, rnd))
    if chmax is None:
        chmax = comm.allmax(channel_age_max(cfg, inbox_data, delivered,
                                            rnd))
    hwm = torch.maximum(ls.age_hwm, chmax)
    dead_hist = age_hist(inbox_data, live & dead[:, None], rnd)
    rows = [torch.zeros(N_BUCKETS, dtype=_I32, device=dlv.device)
            for _ in range(N_CAUSES)]
    rows[CAUSE_FAULT] = fault_hist
    rows[CAUSE_COMPACT] = compact_hist
    rows[CAUSE_OUTBOX] = outbox_hist
    rows[CAUSE_DEAD] = dead_hist
    return LatencyState(deliver=ls.deliver + dlv,
                        drop_age=ls.drop_age + comm.allsum(
                            torch.stack(rows)),
                        age_hwm=hwm)


def record_flight(cfg, fl: FlightState, *, rnd, rnd_host: int, sent,
                  sent_wire, dropped, owned: bool) -> FlightState:
    """Write one round's wire capture into ring slot ``rnd % K``.  The
    interleave writes the wire stack (``sent``, word planes) straight
    into the slot, unless the round already interleaved it for its trace
    (``sent_wire``).  ``rnd_host`` is the round as a host int, read with
    the round's route gate, so the slot costs no host read of its own.
    A ring the caller does not ``own`` (one it did not copy earlier in
    the same run) is copied first, so the state handed in keeps its
    ring."""
    if not owned:
        fl = FlightState(rnd=fl.rnd.clone(), sent=fl.sent.clone(),
                         dropped=fl.dropped.clone())
    slot = rnd_host % cfg.flight_rounds
    if sent_wire is not None:
        fl.sent[slot].copy_(sent_wire)
    else:
        plane_ops.interleave(sent, out=fl.sent[slot])
    fl.dropped[slot].copy_(dropped)
    fl.rnd[slot].copy_(rnd)
    return fl


# ---------------------------------------------------------------------------
# Host-side readers
# ---------------------------------------------------------------------------

def snapshot(ls: LatencyState) -> dict:
    """``{"deliver": [C, B], "drop_age": [N_CAUSES, B], "age_hwm": [C],
    "bounds": [B-1]}`` on the host."""
    return {
        "deliver": ls.deliver.cpu().numpy(),
        "drop_age": ls.drop_age.cpu().numpy(),
        "age_hwm": ls.age_hwm.cpu().numpy(),
        "bounds": np.asarray(BUCKET_BOUNDS),
    }


def _bucket_upper(k: int, hwm: int) -> int:
    """Upper age edge of bucket k, clamped to the observed maximum."""
    if k <= 0:
        return 0
    if k >= N_BUCKETS - 1:
        return int(hwm)
    return min((1 << k) - 1, int(hwm))


def percentiles(ls_or_snap, channels: tuple | None = None) -> dict:
    """p50/p95/p99/max delivery age per channel, in rounds: the upper
    edge of the bucket where the cumulative count crosses the quantile;
    ``max`` is the exact high-water mark."""
    snap = ls_or_snap if isinstance(ls_or_snap, dict) \
        else snapshot(ls_or_snap)
    dlv = np.asarray(snap["deliver"])
    hwm = np.asarray(snap["age_hwm"])
    C = dlv.shape[0]
    names = tuple(channels) if channels is not None \
        else tuple(f"ch{i}" for i in range(C))
    out: dict = {}
    for c in range(C):
        counts = dlv[c]
        total = int(counts.sum())
        entry = {"count": total, "max": int(hwm[c])}
        cum = counts.cumsum()
        for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            if total == 0:
                entry[label] = None
                continue
            k = int(np.searchsorted(cum, q * total))
            entry[label] = _bucket_upper(min(k, N_BUCKETS - 1),
                                         int(hwm[c]))
        out[names[c]] = entry
    return out


def window_snap(prev: dict | None, cur: dict) -> dict:
    """A :func:`percentiles` input over the deliveries between two
    cumulative snapshots (the high-water mark stays cumulative)."""
    if prev is None:
        return cur
    return {
        "deliver": np.asarray(cur["deliver"]) - np.asarray(prev["deliver"]),
        "drop_age": np.asarray(cur["drop_age"])
        - np.asarray(prev["drop_age"]),
        "age_hwm": cur["age_hwm"],
        "bounds": cur["bounds"],
    }


def breach_accounting(rows, *, slo_rounds: int,
                      channels: tuple | None = None) -> dict:
    """Per-channel SLO breaches over a windowed p99 series of ``(round,
    k, p99_by_channel)`` rows: a window breaches when its p99 exceeds
    ``slo_rounds``.  Returns ``{channel: [(round, k, breached), ...]}``."""
    out: dict = {ch: [] for ch in (channels or ())}
    for rnd, k, p99 in rows:
        for ch, v in (p99 or {}).items():
            if channels is not None and ch not in out:
                continue
            out.setdefault(ch, []).append(
                (int(rnd), int(k),
                 bool(v is not None and v > slo_rounds)))
    return out


def flight_trace(fl: FlightState):
    """The ring as a ``trace.Trace`` ordered by round."""
    from partisan_tpu_torch.trace import Trace

    rnd = fl.rnd.cpu().numpy()
    idx = metrics_mod.ring_order(rnd)
    return Trace(fl.sent.cpu().numpy()[idx], fl.dropped.cpu().numpy()[idx],
                 rnd[idx])
