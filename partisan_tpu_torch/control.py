"""In-round feedback controllers (port of ``partisan_tpu/control.py``):
pure functions of the observability planes' state, evaluated at the end
of every round; the next round reads the operands they write.

- **Fanout governor** (``Config.control.fanout``, reads provenance):
  windows of the redundancy ring's duplicate/gossip counts and the
  GRAFT delivered counter step a per-round eager-link budget between
  ``fanout_min`` and the overlay width; Plumtree's eager push demotes
  the links beyond it to the lazy I_HAVE path.
- **Channel backpressure** (``Config.control.backpressure``, reads
  latency, acts in the channel-capacity outbox): each channel's
  delivered-age high-water mark integrates into a pressure level, and
  pressure lowers the channel's stale-shed age threshold
  (:func:`shed_age`, applied by ``channels.throttle``).
- **Self-healing** (``Config.control.healing``, reads the health
  digest): HyParView's shuffle/promotion cadences and isolation window
  are divided by ``2**boost`` while the digest shows a degraded overlay,
  and relax after ``heal_hold`` healthy snapshots.

A disabled controller's sub-state is ``()``.  Every input is a plane
value already on the card and every decision a tensor op, so a round
with controllers on makes no more host reads than without; each
controller keeps a decision ring (slot ``rnd % ring``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import metrics as metrics_mod

_BIG = 2 ** 30
_I32 = torch.int32


class FanoutState(NamedTuple):
    """Eager-fanout governor; ``band_*`` are the hysteresis bands as
    state operands (initialized from the config)."""

    eager_cap: torch.Tensor    # int32 — eager links per (node, tree)
    win_dup: torch.Tensor      # int32 — duplicates in the window
    win_gossip: torch.Tensor   # int32 — gossip deliveries, window
    win_graft: torch.Tensor    # int32 — GRAFTs delivered, window
    adjustments: torch.Tensor  # int32 — cap changes, whole run
    rnd: torch.Tensor          # int32[R] — decision-ring labels (-1)
    cap: torch.Tensor          # int32[R] — cap after each round
    band_min: torch.Tensor     # int32
    band_hi: torch.Tensor      # int32
    band_lo: torch.Tensor      # int32
    band_graft: torch.Tensor   # int32


class BackpressureState(NamedTuple):
    """Per-channel shed-pressure integrator (``C`` = n_channels)."""

    press: torch.Tensor        # int32[C] — pressure level per channel
    adjustments: torch.Tensor  # int32
    rnd: torch.Tensor          # int32[R]
    press_ring: torch.Tensor   # int32[R, C]
    band_age_hi: torch.Tensor  # int32
    band_age_lo: torch.Tensor  # int32


class HealingState(NamedTuple):
    """Overlay repair escalation."""

    boost: torch.Tensor        # int32 — cadence right-shift (0 = base)
    streak: torch.Tensor       # int32 — consecutive healthy snapshots
    adjustments: torch.Tensor  # int32
    rnd: torch.Tensor          # int32[R]
    boost_ring: torch.Tensor   # int32[R]
    band_boost: torch.Tensor   # int32
    band_hold: torch.Tensor    # int32


class ControlState(NamedTuple):
    fanout: Any = ()
    backpressure: Any = ()
    healing: Any = ()


def enabled(cfg) -> bool:
    return cfg.control.any


def _overlay_width(cfg) -> int:
    """The eager-cap ceiling: the manager's neighbor-slot width."""
    from partisan_tpu_torch import managers as managers_mod

    return max(1, managers_mod.neighbor_width(cfg))


def init(cfg, device=None) -> ControlState:
    R = cfg.control.ring
    c = cfg.control

    def s(v):
        return torch.tensor(v, dtype=_I32, device=device)

    def ring():
        return torch.full((R,), -1, dtype=_I32, device=device)

    fan, bp, heal = (), (), ()
    if c.fanout:
        fan = FanoutState(
            eager_cap=s(_overlay_width(cfg)), win_dup=s(0),
            win_gossip=s(0), win_graft=s(0), adjustments=s(0),
            rnd=ring(), cap=torch.zeros((R,), dtype=_I32, device=device),
            band_min=s(c.fanout_min), band_hi=s(c.fanout_hi_pct),
            band_lo=s(c.fanout_lo_pct), band_graft=s(c.graft_hi_pct))
    if c.backpressure:
        C = cfg.n_channels
        bp = BackpressureState(
            press=torch.zeros((C,), dtype=_I32, device=device),
            adjustments=s(0), rnd=ring(),
            press_ring=torch.zeros((R, C), dtype=_I32, device=device),
            band_age_hi=s(c.age_hi), band_age_lo=s(c.age_lo))
    if c.healing:
        heal = HealingState(
            boost=s(0), streak=s(0), adjustments=s(0), rnd=ring(),
            boost_ring=torch.zeros((R,), dtype=_I32, device=device),
            band_boost=s(c.heal_boost), band_hold=s(c.heal_hold))
    return ControlState(fanout=fan, backpressure=bp, healing=heal)


# ---------------------------------------------------------------------------
# Operand readers (the round reads the round-start state)
# ---------------------------------------------------------------------------

def shed_age(cfg, bp: BackpressureState) -> torch.Tensor:
    """int32[C]: each channel's stale-shed age threshold this round:
    none at zero pressure, else ``band_age_hi >> (press - 1)`` down to a
    floor of 1 round."""
    floor = torch.clamp(
        bp.band_age_hi >> torch.clamp(bp.press - 1, min=0), min=1)
    return torch.where(bp.press > 0, floor, _BIG).to(_I32)


def pressure_signal(cfg, comm, inbox_data, dead: torch.Tensor, rnd
                    ) -> torch.Tensor:
    """int32[C]: this round's delivered-age high-water mark per channel
    (the backpressure sensor), over the same pre-mask inbox and dead mask
    as ``latency.record_round``."""
    from partisan_tpu_torch import latency as latency_mod
    from partisan_tpu_torch import types as T

    live = inbox_data[T.W_KIND] != 0
    return latency_mod.channel_age_max(cfg, inbox_data,
                                       live & ~dead[:, None], rnd)


# ---------------------------------------------------------------------------
# The per-round update
# ---------------------------------------------------------------------------

def _fanout_update(cfg, fs: FanoutState, rnd, pv) -> FanoutState:
    """Accumulate the round's duplicate/gossip/GRAFT counts (the ring
    row provenance just wrote) and, once every ``fanout_every`` rounds,
    demote one eager link on a hot window or promote one on a cold or
    GRAFT-heavy window; quiet windows hold the budget."""
    from partisan_tpu_torch.provenance import CTL_NAMES

    c = cfg.control
    slot = torch.remainder(rnd, cfg.provenance_ring).reshape(1)
    w_dup = fs.win_dup + pv.dup.index_select(0, slot).sum().to(_I32)
    w_gos = fs.win_gossip + pv.gossip.index_select(0, slot)[0]
    w_gra = fs.win_graft + pv.ctl.index_select(0, slot)[
        0, CTL_NAMES.index("graft"), 1]
    evaluate = torch.remainder(rnd + 1, c.fanout_every) == 0
    measurable = w_gos >= c.fanout_gossip_min
    hot = measurable & (w_dup * 100 >= fs.band_hi * w_gos)
    storm = measurable & (w_gra * 100 >= fs.band_graft * w_gos)
    cold = measurable & (w_dup * 100 <= fs.band_lo * w_gos)
    promote = evaluate & (storm | cold)
    demote = evaluate & hot & ~promote
    cap = fs.eager_cap + promote.to(_I32) - demote.to(_I32)
    cap = torch.maximum(cap, fs.band_min).clamp(max=_overlay_width(cfg))
    stepped = cap != fs.eager_cap
    rslot = torch.remainder(rnd, c.ring)
    return fs._replace(
        eager_cap=cap,
        win_dup=torch.where(evaluate, 0, w_dup).to(_I32),
        win_gossip=torch.where(evaluate, 0, w_gos).to(_I32),
        win_graft=torch.where(evaluate, 0, w_gra).to(_I32),
        adjustments=(fs.adjustments + stepped.to(_I32)).to(_I32),
        rnd=metrics_mod.put(fs.rnd, rslot, rnd),
        cap=metrics_mod.put(fs.cap, rslot, cap))


def _backpressure_update(cfg, bp: BackpressureState, rnd, chmax
                         ) -> BackpressureState:
    """At or above ``age_hi`` a channel's pressure rises, at or below
    ``age_lo`` it decays, bounded by ``press_max``."""
    c = cfg.control
    up = chmax >= bp.band_age_hi
    down = chmax <= bp.band_age_lo
    press = torch.clamp(bp.press + up.to(_I32) - down.to(_I32),
                        0, c.press_max).to(_I32)
    changed = (press != bp.press).sum().to(_I32)
    rslot = torch.remainder(rnd, c.ring)
    return bp._replace(
        press=press, adjustments=(bp.adjustments + changed).to(_I32),
        rnd=metrics_mod.put(bp.rnd, rslot, rnd),
        press_ring=metrics_mod.put(bp.press_ring, rslot, press))


def _healing_update(cfg, hs: HealingState, rnd, health) -> HealingState:
    """Decisions move on snapshot rounds only (``(rnd+1) % health ==
    0``): a degraded digest sets the boost, ``band_hold`` healthy
    snapshots in a row clear it; the ring records every round."""
    from partisan_tpu_torch import health as health_mod

    c = cfg.control
    due = torch.remainder(rnd + 1, cfg.health) == 0
    word = health.digest
    valid = (word & health_mod.DIGEST_VALID) != 0
    ok_bits = health_mod.OVERLAY_BITS
    degraded = valid & ((word & ok_bits) != ok_bits)
    streak_s = torch.where(degraded, 0, hs.streak + valid.to(_I32))
    boost_s = torch.where(
        degraded, hs.band_boost,
        torch.where(streak_s >= hs.band_hold, 0, hs.boost))
    boost = torch.where(due, boost_s, hs.boost).to(_I32)
    streak = torch.where(due, streak_s, hs.streak).to(_I32)
    rslot = torch.remainder(rnd, c.ring)
    return hs._replace(
        boost=boost, streak=streak,
        adjustments=(hs.adjustments + (boost != hs.boost).to(_I32)
                     ).to(_I32),
        rnd=metrics_mod.put(hs.rnd, rslot, rnd),
        boost_ring=metrics_mod.put(hs.boost_ring, rslot, boost))


def update(cfg, cs: ControlState, *, rnd, pv=None, health=None,
           chmax=None) -> ControlState:
    """One controller step at the end of the round, on the planes'
    freshly written states."""
    fan, bp, heal = cs.fanout, cs.backpressure, cs.healing
    if cfg.control.fanout:
        fan = _fanout_update(cfg, fan, rnd, pv)
    if cfg.control.backpressure:
        bp = _backpressure_update(cfg, bp, rnd, chmax)
    if cfg.control.healing:
        heal = _healing_update(cfg, heal, rnd, health)
    return ControlState(fanout=fan, backpressure=bp, healing=heal)


# ---------------------------------------------------------------------------
# Host-side readers
# ---------------------------------------------------------------------------

def poll(cs: ControlState) -> dict:
    """The controllers' current operands (a few scalar reads)."""
    out: dict = {}
    if cs.fanout != ():
        out["eager_cap"] = int(cs.fanout.eager_cap)
        out["fanout_adjustments"] = int(cs.fanout.adjustments)
    if cs.backpressure != ():
        out["press"] = cs.backpressure.press.cpu().numpy().astype(int) \
            .tolist()
    if cs.healing != ():
        out["heal_boost"] = int(cs.healing.boost)
    return out


def snapshot(cs: ControlState) -> dict:
    """The decision rings ordered by round."""
    def h(x):
        return x.cpu().numpy()

    out: dict = {}
    if cs.fanout != ():
        rnd = h(cs.fanout.rnd)
        idx = metrics_mod.ring_order(rnd)
        out["fanout"] = {"rounds": rnd[idx], "cap": h(cs.fanout.cap)[idx],
                         "eager_cap": int(cs.fanout.eager_cap),
                         "adjustments": int(cs.fanout.adjustments)}
    if cs.backpressure != ():
        rnd = h(cs.backpressure.rnd)
        idx = metrics_mod.ring_order(rnd)
        out["backpressure"] = {
            "rounds": rnd[idx],
            "press": h(cs.backpressure.press_ring)[idx],
            "current": h(cs.backpressure.press),
            "adjustments": int(cs.backpressure.adjustments)}
    if cs.healing != ():
        rnd = h(cs.healing.rnd)
        idx = metrics_mod.ring_order(rnd)
        out["healing"] = {"rounds": rnd[idx],
                          "boost": h(cs.healing.boost_ring)[idx],
                          "current": int(cs.healing.boost),
                          "adjustments": int(cs.healing.adjustments)}
    return out


def decisions(snap: dict, *, channels: tuple | None = None) -> list[dict]:
    """The rings' discrete moves, one dict per round where an operand
    changed: ``fanout_adjusted``, ``shed_threshold_changed`` (per
    channel) and ``healing_escalated`` (with its direction)."""
    out: list[dict] = []
    fan = snap.get("fanout")
    if fan is not None:
        rounds, cap = np.asarray(fan["rounds"]), np.asarray(fan["cap"])
        for i in range(1, len(rounds)):
            if cap[i] != cap[i - 1]:
                out.append({"kind": "fanout_adjusted",
                            "round": int(rounds[i]),
                            "cap": int(cap[i]), "prev": int(cap[i - 1])})
    bp = snap.get("backpressure")
    if bp is not None:
        rounds, press = np.asarray(bp["rounds"]), np.asarray(bp["press"])
        C = press.shape[1] if press.ndim == 2 else 0
        given = tuple(channels) if channels is not None else ()
        names = tuple(given[i] if i < len(given) else f"ch{i}"
                      for i in range(C))
        for i in range(1, len(rounds)):
            for c in range(C):
                if press[i, c] != press[i - 1, c]:
                    out.append({"kind": "shed_threshold_changed",
                                "round": int(rounds[i]),
                                "channel": names[c],
                                "press": int(press[i, c]),
                                "prev": int(press[i - 1, c])})
    heal = snap.get("healing")
    if heal is not None:
        rounds, boost = np.asarray(heal["rounds"]), np.asarray(heal["boost"])
        for i in range(1, len(rounds)):
            if boost[i] != boost[i - 1]:
                out.append({"kind": "healing_escalated",
                            "round": int(rounds[i]),
                            "boost": int(boost[i]),
                            "prev": int(boost[i - 1]),
                            "direction": "escalate"
                            if boost[i] > boost[i - 1] else "relax"})
    return out
