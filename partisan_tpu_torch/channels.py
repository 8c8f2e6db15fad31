"""Per-channel parallelism capacity: N lanes per edge, enforced (port of
``partisan_tpu/channels.py``).

Opt-in with ``Config.channel_capacity``:

- a message's lane is its partition-key word (``W_LANE``) modulo its
  channel's ``parallelism``;
- each (edge, channel, lane) carries at most ``lane_rate`` messages a
  round, so an edge's per-channel throughput is ``parallelism ×
  lane_rate`` per round;
- excess sends defer into a bounded per-node outbox replayed first next
  round (per-sender FIFO: outbox slots precede fresh emissions and the
  ranking is stable); outbox overflow sheds, counted in ``shed``.

An edge's lanes have no setup phase, so all of them are up exactly when
both endpoints are alive (:func:`fully_connected`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import latency as latency_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops


class OutboxState(NamedTuple):
    data: plane_ops.Planes  # [n, outbox_cap] records — deferred sends
    shed: torch.Tensor      # int32 — deferred sends dropped (overflow)


def enabled(cfg) -> bool:
    return cfg.channel_capacity


def init(cfg, comm) -> OutboxState:
    return OutboxState(
        data=msg_ops.zero_wire(cfg, (comm.n_local, cfg.outbox_cap),
                               device=comm.device),
        shed=torch.zeros((), dtype=torch.int32, device=comm.device))


def throttle(cfg, comm, ob: OutboxState, emitted: plane_ops.Planes, *,
             birth_rnd=None, shed_age=None):
    """Apply per-(edge, channel, lane) capacity to this round's sends.
    Returns (outbox', emitted'): emitted' holds the outbox's deferred
    sends first, then the fresh ones, with every send beyond its lane's
    budget cleared; those defer into the outbox, or shed when it is
    full.  With ``birth_rnd`` (the latency plane on) a third value is
    returned: the age histogram of the records shed at the outbox cut.
    ``shed_age`` (int32[C], needs ``birth_rnd``) is the backpressure
    controller's per-channel threshold: a record at least that old is
    shed before the capacity ranking."""
    par_py = [c.parallelism for c in cfg.channels]
    OB = cfg.outbox_cap
    both = plane_ops.concat([ob.data, emitted], dim=1)        # [n, M]
    kind = both[T.W_KIND]
    n, M = kind.shape
    dev = kind.device
    valid = kind != 0
    par = torch.tensor(par_py, dtype=torch.int32, device=dev)
    ch = both[T.W_CHANNEL].to(torch.int32).clamp(0, cfg.n_channels - 1)
    stale = None
    if shed_age is not None:
        if birth_rnd is None:
            raise ValueError("shed_age needs birth_rnd (the latency "
                             "plane's ages)")
        stale = valid & (latency_mod.ages(both, birth_rnd)
                         >= shed_age[ch.to(torch.int64)])
        valid = valid & ~stale
    lane = (both[T.W_LANE] & 0x7FFFFFFF) % par[ch.to(torch.int64)]
    key = (both[T.W_DST].clamp(min=0) * cfg.n_channels + ch) \
        * max(par_py) + lane
    key = torch.where(valid, key, -1)

    # Rank among same-key sends, stable by slot (outbox first = FIFO): a
    # stable per-row sort groups equal keys in slot order, so the rank is
    # the offset from the run's start; the sort permutation's indices are
    # unique, so scattering the ranks back is exact.
    m_idx = torch.arange(M, dtype=torch.int64, device=dev)
    skey, order = torch.sort(key, dim=1, stable=True)
    is_start = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                          skey[:, 1:] != skey[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, m_idx, 0), dim=1)[0]
    rank = torch.empty_like(order).scatter_(1, order, m_idx - run_start)
    send_now = valid & (rank < cfg.lane_rate)
    defer = valid & ~send_now
    out = plane_ops.set_word(both, T.W_KIND, torch.where(send_now, kind, 0))

    # Deferred sends pack into the outbox in slot order (FIFO).
    keep = defer & (torch.cumsum(defer, dim=1) - 1 < OB)
    pos = torch.sort(torch.where(keep, m_idx, M), dim=1)[0][:, :OB]
    cut = defer & ~keep
    if stale is not None:
        # backpressure sheds join the outbox cut (CAUSE_OUTBOX)
        cut = cut | stale
    ob_out = OutboxState(data=plane_ops.take_rows(both, pos, fill=True),
                         shed=ob.shed + comm.allsum(cut.sum().to(torch.int32)))
    if birth_rnd is None:
        return ob_out, out
    return ob_out, out, latency_mod.age_hist(both, cut, birth_rnd)


def shed_delta(before: OutboxState, after: OutboxState) -> torch.Tensor:
    """int32: sends shed at the outbox cut this round (``shed`` is
    cumulative)."""
    return after.shed - before.shed


def fully_connected(cfg, alive: torch.Tensor) -> torch.Tensor:
    """bool[n, n]: every configured lane of every channel between i and
    j is up — exactly when both endpoints are alive."""
    return alive[:, None] & alive[None, :]
