"""Device-resident broadcast provenance plane (port of
``partisan_tpu/provenance.py``): who delivered each broadcast copy,
along what tree, at what hop depth, and how much of the gossip traffic
was redundant.

**Wire** (``Config(provenance=True)``): every event-lane record grows two
trailing words, ``(prov_src, prov_hop)``, appended by the round after
the protocol built its ``msg_words``-wide records: ``prov_src`` is the
emitting row's id (int32), ``prov_hop`` the sender's tree depth read
from the model's :class:`ProvSpec` hop word (int16; 0 for models
without one).  Queued copies carry the pair verbatim.  Layout: protocol
words, then ``msg_words`` = src, ``msg_words + 1`` = hop, then the
latency plane's birth round, always last.

**Accumulation** (no host read): the spanning forest ``parent/hop/
claim_rnd/epoch [n, B]`` (first-delivery parent, claimed depth, claim
round, slot epoch; a higher epoch resets the entry; within a round the
winner is the minimum ``(hop, sender)`` key, a scatter-min onto a padded
drop column, order-free); the redundancy ring ``dup [R, C]``,
``gossip``, ``claims`` and the control counters ``ctl [R, N_CTL, 2]``
(PRUNE, GRAFT, I_HAVE, IGNORED_I_HAVE emitted and delivered);
``depth_hwm [B]``, ``cover_rnd [B]`` (first round of full coverage) and
whole-run totals.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import metrics as metrics_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops import scatter

CTL_KINDS = (int(T.MsgKind.PT_PRUNE), int(T.MsgKind.PT_GRAFT),
             int(T.MsgKind.PT_IHAVE), int(T.MsgKind.PT_IHAVE_ACK))
CTL_NAMES = ("prune", "graft", "i_have", "ignored_i_have")
N_CTL = len(CTL_KINDS)

_BIG = 2 ** 30
_I32 = torch.int32


class ProvSpec(NamedTuple):
    """How a broadcast model's gossip records read: ``kind`` of the
    data-bearing copies, the word of the broadcast slot, of the sender's
    hop (None: every claim lands at hop 1), of the slot-recycle epoch
    (None: no resets), and an optional extra payload filter."""

    kind: int
    slot_word: int
    hop_word: int | None = None
    epoch_word: int | None = None
    match_word: int | None = None
    match_val: int = 0


class ProvenanceState(NamedTuple):
    """Spanning forest + redundancy rings (``B`` = max_broadcasts, ``R``
    = provenance_ring, ``C`` = n_channels)."""

    parent: torch.Tensor     # int32[n, B] — first-delivery parent (-1)
    hop: torch.Tensor        # int32[n, B] — claimed depth
    claim_rnd: torch.Tensor  # int32[n, B] — round of the claim (-1)
    epoch: torch.Tensor      # int32[n, B] — epoch the claim belongs to
    rnd: torch.Tensor        # int32[R] — ring round labels (-1)
    dup: torch.Tensor        # int32[R, C] — duplicate gossip deliveries
    gossip: torch.Tensor     # int32[R] — gossip copies delivered
    claims: torch.Tensor     # int32[R] — first-delivery claims
    ctl: torch.Tensor        # int32[R, N_CTL, 2] — (emitted, delivered)
    depth_hwm: torch.Tensor  # int32[B]
    cover_rnd: torch.Tensor  # int32[B] — first full-coverage round (-1)
    dup_cum: torch.Tensor    # int32 — duplicates, whole run
    gossip_cum: torch.Tensor  # int32 — gossip deliveries, whole run


def enabled(cfg) -> bool:
    return cfg.provenance


def spec_of(model) -> ProvSpec | None:
    """The model's descriptor, or None (the pair is still threaded)."""
    if model is None or not hasattr(model, "prov_spec"):
        return None
    return model.prov_spec


def src_word(cfg) -> int:
    return cfg.msg_words


def hop_word(cfg) -> int:
    return cfg.msg_words + 1


def _gid_bits(n_nodes: int) -> int:
    """Bits of a node id: the packed claim key is ``hop << bits | src``,
    so its minimum is the lexicographic (hop, sender) minimum."""
    return max(1, (n_nodes - 1).bit_length())


def init(cfg, comm) -> ProvenanceState:
    B, R, C = cfg.max_broadcasts, cfg.provenance_ring, cfg.n_channels
    n, dev = comm.n_local, comm.device

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    def neg(*shape):
        return torch.full(shape, -1, dtype=_I32, device=dev)

    return ProvenanceState(
        parent=neg(n, B), hop=z(n, B), claim_rnd=neg(n, B), epoch=z(n, B),
        rnd=neg(R), dup=z(R, C), gossip=z(R), claims=z(R),
        ctl=z(R, N_CTL, 2), depth_hwm=z(B), cover_rnd=neg(B),
        dup_cum=z(), gossip_cum=z())


# ---------------------------------------------------------------------------
# Wire-pair threading
# ---------------------------------------------------------------------------

def _match(spec: ProvSpec, msgs) -> torch.Tensor:
    m = msgs[T.W_KIND] == spec.kind
    if spec.match_word is not None:
        m = m & (msgs[spec.match_word] == spec.match_val)
    return m


def stamp(cfg, spec: ProvSpec | None, emitted: plane_ops.Planes,
          gids: torch.Tensor) -> plane_ops.Planes:
    """Append the provenance pair to a freshly emitted ``[n, E]`` stack:
    ``prov_src`` the emitting row's id in every slot, ``prov_hop`` the
    model's hop word on matching gossip records (0 elsewhere), stored
    int16.  Both planes are materialized (the interleave kernel takes
    contiguous planes only)."""
    shape = emitted[0].shape
    src = gids.reshape((-1,) + (1,) * (len(shape) - 1)).to(_I32)
    hop_dt = T.wire_dtype(hop_word(cfg), cfg.msg_words, provenance=True)
    if spec is not None and spec.hop_word is not None:
        hop = torch.where(_match(spec, emitted),
                          emitted[spec.hop_word], 0).to(hop_dt)
    else:
        hop = torch.zeros((), dtype=hop_dt, device=src.device)
    return plane_ops.append_words(emitted, src, hop)


def stamp_fresh(cfg, msgs: plane_ops.Planes) -> plane_ops.Planes:
    """Set ``prov_src`` on control records built mid-round (the builder
    is the sender: it copies ``W_SRC``; the hop stays 0).  Retransmit
    replays are not restamped.  No-op when the plane is off."""
    if not cfg.provenance:
        return msgs
    live = msgs[T.W_KIND] != 0
    return plane_ops.set_word(msgs, src_word(cfg),
                              torch.where(live, msgs[T.W_SRC], 0))


# ---------------------------------------------------------------------------
# In-round accumulation
# ---------------------------------------------------------------------------

def _ctl_counts(msgs, valid: torch.Tensor) -> torch.Tensor:
    """int32[N_CTL]: control-kind counts among ``valid`` slots."""
    kind = msgs[T.W_KIND]
    return torch.stack([((kind == k) & valid).sum() for k in CTL_KINDS]
                       ).to(_I32)


def record_round(cfg, comm, spec: ProvSpec | None, ps: ProvenanceState, *,
                 rnd, emitted, inbox_data, dead, alive_local
                 ) -> ProvenanceState:
    """Accumulate one round.  ``emitted`` is the post-outbound pre-wire
    stack (control emitted counts), ``inbox_data`` the routed inbox
    before the dead-receiver mask and ``dead`` that mask."""
    R = cfg.provenance_ring
    slot = torch.remainder(rnd, R)
    live_in = inbox_data[T.W_KIND] != 0
    delivered = live_in & ~dead[:, None]
    dev = live_in.device

    # the inputs are this shard's rows: counts and rings reduce before
    # they are written, the forest tables stay per node
    ctl_e = comm.allsum(_ctl_counts(emitted, emitted[T.W_KIND] != 0))
    ctl_d = comm.allsum(_ctl_counts(inbox_data, delivered))
    ctl_row = torch.stack([ctl_e, ctl_d], dim=-1)         # [N_CTL, 2]

    parent, hop, crnd, epoch = ps.parent, ps.hop, ps.claim_rnd, ps.epoch
    dup_ch = torch.zeros(cfg.n_channels, dtype=_I32, device=dev)
    n_g = torch.zeros((), dtype=_I32, device=dev)
    n_claims = torch.zeros((), dtype=_I32, device=dev)

    if spec is not None:
        B = cfg.max_broadcasts
        n_local, cap = live_in.shape
        bits = _gid_bits(cfg.n_nodes)
        hop_max = (1 << (30 - bits)) - 1

        g = delivered & _match(spec, inbox_data)                 # [n, cap]
        b = inbox_data[spec.slot_word].to(_I32).clamp(0, B - 1)
        b64 = b.to(torch.int64)
        b_or_pad = torch.where(g, b, B)

        # a recycled slot's higher epoch resets the entry; stale-epoch
        # copies still count as duplicates
        if spec.epoch_word is not None:
            e = inbox_data[spec.epoch_word].to(_I32)
            ep_tab = scatter.reduce_drop(epoch, b_or_pad, e, "amax")
            bumped = ep_tab > epoch
            parent = torch.where(bumped, -1, parent)
            hop = torch.where(bumped, 0, hop)
            crnd = torch.where(bumped, -1, crnd)
            epoch = ep_tab
            cur = g & (e == torch.gather(ep_tab, 1, b64))
        else:
            cur = g

        # first-delivery claims: min (hop, sender) packed key
        par_b = torch.gather(parent, 1, b64)
        claimable = cur & (par_b < 0)
        # widen the int16 hop before the clip (hop_max wraps in int16)
        ph = inbox_data[hop_word(cfg)].to(_I32).clamp(0, hop_max)
        psrc = inbox_data[src_word(cfg)].to(_I32).clamp(0, cfg.n_nodes - 1)
        key = (ph << bits) | psrc
        kmin = scatter.reduce_drop(
            torch.full((n_local, B), _BIG, dtype=_I32, device=dev),
            torch.where(claimable, b, B), key, "amin")
        won = kmin < _BIG
        parent = torch.where(won, kmin & ((1 << bits) - 1), parent)
        hop = torch.where(won, (kmin >> bits) + 1, hop)
        crnd = torch.where(won, rnd, crnd)

        # the winning copy (min inbox slot among key-minimal copies)
        winner = claimable & (key == torch.gather(kmin, 1, b64))
        slot_c = torch.arange(cap, dtype=_I32, device=dev).expand(
            n_local, cap)
        smin = scatter.reduce_drop(
            torch.full((n_local, B), cap, dtype=_I32, device=dev),
            torch.where(winner, b, B), slot_c, "amin")
        claim_copy = winner & (slot_c == torch.gather(smin, 1, b64))
        dup_ch = comm.allsum(metrics_mod.channel_counts(
            cfg, inbox_data, mask=g & ~claim_copy))
        n_g = comm.allsum(g.sum().to(_I32))
        n_claims = comm.allsum(claim_copy.sum().to(_I32))

    depth_hwm = torch.maximum(ps.depth_hwm, comm.allmax(
        torch.where(parent >= 0, hop, 0).max(dim=0).values))
    covered = (parent >= 0) & alive_local[:, None]
    cnt = comm.allsum(covered.sum(dim=0).to(_I32))              # [B]
    n_alive = comm.allsum(alive_local.sum().to(_I32))
    full = (n_alive > 0) & (cnt == n_alive)
    cover_rnd = torch.where((ps.cover_rnd < 0) & full, rnd, ps.cover_rnd)

    put = metrics_mod.put
    return ProvenanceState(
        parent=parent.to(_I32), hop=hop.to(_I32), claim_rnd=crnd.to(_I32),
        epoch=epoch.to(_I32),
        rnd=put(ps.rnd, slot, rnd), dup=put(ps.dup, slot, dup_ch),
        gossip=put(ps.gossip, slot, n_g),
        claims=put(ps.claims, slot, n_claims),
        ctl=put(ps.ctl, slot, ctl_row),
        depth_hwm=depth_hwm.to(_I32), cover_rnd=cover_rnd.to(_I32),
        dup_cum=(ps.dup_cum + dup_ch.sum()).to(_I32),
        gossip_cum=(ps.gossip_cum + n_g).to(_I32))


# ---------------------------------------------------------------------------
# Scenario helpers
# ---------------------------------------------------------------------------

def mark_origin(ps: ProvenanceState, node: int, slot: int, *, rnd=0,
                epoch: int | None = None) -> ProvenanceState:
    """Mark ``node`` as the root of broadcast ``slot`` (parent = self,
    hop 0); re-mark after a ``fresh=True`` recycle with the slot's new
    ``epoch``.  Returns new tensors; ``ps`` is untouched."""
    def set_at(t, v):
        t = t.clone()
        t[node, slot] = v
        return t

    ep = ps.epoch
    if epoch is not None:
        ep = ep.clone()
        ep[node, slot] = torch.clamp(ep[node, slot], min=int(epoch))
    return ps._replace(parent=set_at(ps.parent, node),
                       hop=set_at(ps.hop, 0),
                       claim_rnd=set_at(ps.claim_rnd, rnd),
                       epoch=ep)


# ---------------------------------------------------------------------------
# Host-side readers
# ---------------------------------------------------------------------------

_RING = ("dup", "gossip", "claims", "ctl")


def snapshot(ps: ProvenanceState) -> dict:
    """The plane on the host: forest tables, ring series ordered by
    round, cumulative totals."""
    def h(x):
        return x.cpu().numpy()

    rnd = h(ps.rnd)
    idx = metrics_mod.ring_order(rnd)
    out: dict = {
        "parent": h(ps.parent), "hop": h(ps.hop),
        "claim_rnd": h(ps.claim_rnd), "epoch": h(ps.epoch),
        "rounds": rnd[idx],
        "depth_hwm": h(ps.depth_hwm), "cover_rnd": h(ps.cover_rnd),
        "dup_total": int(ps.dup_cum), "gossip_total": int(ps.gossip_cum),
    }
    for name in _RING:
        out[name] = h(getattr(ps, name))[idx]
    return out


def redundancy(snap_or_ps) -> dict:
    """Whole-run duplicates / gossip deliveries."""
    snap = snap_or_ps if isinstance(snap_or_ps, dict) \
        else snapshot(snap_or_ps)
    g, d = snap["gossip_total"], snap["dup_total"]
    return {"gossip_delivered": int(g), "duplicates": int(d),
            "redundancy_ratio": round(d / g, 4) if g else None}


def tree(snap_or_ps, slot: int) -> dict:
    """Broadcast ``slot``'s delivered tree: parent/hop arrays plus depth
    and branching statistics."""
    snap = snap_or_ps if isinstance(snap_or_ps, dict) \
        else snapshot(snap_or_ps)
    parent = np.asarray(snap["parent"])[:, slot]
    hop = np.asarray(snap["hop"])[:, slot]
    claimed = parent >= 0
    n = parent.shape[0]
    roots = np.flatnonzero(claimed & (parent == np.arange(n)))
    kids = np.bincount(parent[claimed & (parent != np.arange(n))],
                       minlength=n)
    inner = kids[kids > 0]
    depths = hop[claimed]
    return {
        "slot": int(slot),
        "parent": parent, "hop": hop,
        "claimed": int(claimed.sum()),
        "roots": roots.astype(int).tolist(),
        "depth_max": int(depths.max()) if depths.size else 0,
        "depth_mean": round(float(depths.mean()), 3) if depths.size
        else 0.0,
        "branching_max": int(inner.max()) if inner.size else 0,
        "branching_mean": round(float(inner.mean()), 3) if inner.size
        else 0.0,
        "cover_round": int(np.asarray(snap["cover_rnd"])[slot]),
    }


def rows(snap: dict, channels: tuple | None = None) -> list[dict]:
    """One JSON-ready dict per round of the redundancy/control rings."""
    C = snap["dup"].shape[1] if len(snap["dup"]) else 0
    names = tuple(channels) if channels is not None \
        else tuple(f"ch{i}" for i in range(C))
    out = []
    for i, r in enumerate(snap["rounds"]):
        g = int(snap["gossip"][i])
        d = int(snap["dup"][i].sum())
        out.append({
            "round": int(r),
            "gossip_delivered": g,
            "first_deliveries": int(snap["claims"][i]),
            "duplicates": {names[c]: int(snap["dup"][i, c])
                           for c in range(C)},
            "redundancy_ratio": round(d / g, 4) if g else None,
            "control": {
                CTL_NAMES[j]: {"emitted": int(snap["ctl"][i, j, 0]),
                               "delivered": int(snap["ctl"][i, j, 1])}
                for j in range(N_CTL)},
        })
    return out
