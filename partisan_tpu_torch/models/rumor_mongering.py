"""Demers rumor mongering (port of
``partisan_tpu/models/rumor_mongering.py``).

Infect-and-die gossip: on first receipt of a rumor a node stores it and
owes one forwarding burst to ``FANOUT`` random neighbors; duplicates are
ignored.  A node serves up to ``PER_ROUND`` pending rumors per round,
lowest slot first.  (The reference's provenance descriptor waits for
the provenance plane.)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.models.anti_entropy import pick_neighbors
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import rng

FANOUT = 2        # demers_rumor_mongering.erl:42 ?THIS_FANOUT
PER_ROUND = 2     # pending rumors forwarded per node per round
OP_RUMOR = 3      # APP payload[0] opcode

_PICK_TAG = 211


class RumorState(NamedTuple):
    store: torch.Tensor    # bool[n, max_broadcasts]
    pending: torch.Tensor  # bool[n, max_broadcasts] — owe a forward burst


def _mark(n: int, S: int, slots: torch.Tensor, dev) -> torch.Tensor:
    """bool[n, S]: True at each row's ``slots`` (entries outside [0, S)
    after one negative wrap are dropped)."""
    idx = torch.where(slots < 0, slots + S, slots).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < S), idx, S)
    out = torch.zeros((n, S + 1), dtype=torch.bool, device=dev)
    return out.scatter(1, idx, True)[:, :S]


class RumorMongering:
    name = "demers_rumor_mongering"

    @property
    def prov_spec(self):
        """Provenance descriptor: rumor copies are APP records with
        payload [OP_RUMOR, slot]; no hop word, so every claim lands at
        hop 1."""
        from partisan_tpu_torch import provenance as provenance_mod

        return provenance_mod.ProvSpec(
            kind=int(T.MsgKind.APP), slot_word=T.P1,
            match_word=T.P0, match_val=OP_RUMOR)

    def init(self, cfg, comm) -> RumorState:
        z = torch.zeros((comm.n_local, cfg.max_broadcasts),
                        dtype=torch.bool, device=comm.device)
        return RumorState(store=z, pending=z)

    def step(self, cfg, comm, state: RumorState, ctx, nbrs):
        n, S = state.store.shape
        dev = state.store.device
        gids = comm.local_ids()

        # first receipt -> store + owe a forward; duplicates ignored
        inb = ctx.inbox.data
        is_r = (inb[T.W_KIND] == T.MsgKind.APP) & (inb[T.P0] == OP_RUMOR)
        hit = _mark(n, S, torch.where(is_r, inb[T.P1], S), dev)
        new = hit & ~state.store & ctx.alive[:, None]
        store = state.store | new
        pending = state.pending | new

        # serve the lowest PER_ROUND pending slots, FANOUT neighbors each
        order = torch.sort((~pending).to(torch.int8), dim=1, stable=True)[1]
        first = order[:, :PER_ROUND]
        slots = torch.where(pending.gather(1, first), first.to(torch.int32),
                            -1)
        slots = torch.where(ctx.alive[:, None], slots, -1)
        idx = torch.arange(PER_ROUND, dtype=torch.int64, device=dev)
        slot_keys = rng.fold_in(rng.subkey(ctx.keys, _PICK_TAG)[:, None, :],
                                idx)
        tgts = pick_neighbors(slot_keys, nbrs, FANOUT)  # [n, PER_ROUND, F]
        tgts = torch.where(slots[:, :, None] >= 0, tgts, -1)

        emitted = msg_ops.build(
            cfg, T.MsgKind.APP, gids[:, None, None], tgts,
            payload=(OP_RUMOR, slots[:, :, None]),
        ).map(lambda w: w.reshape(n, PER_ROUND * FANOUT))

        pending = pending & ~_mark(n, S, torch.where(slots >= 0, slots, S),
                                   dev)
        alive = ctx.alive[:, None]
        return RumorState(store=torch.where(alive, store, state.store),
                          pending=torch.where(alive, pending,
                                              state.pending)), emitted

    # ---- scenario helpers --------------------------------------------
    def broadcast(self, state: RumorState, node: int, slot: int
                  ) -> RumorState:
        store, pending = state.store.clone(), state.pending.clone()
        store[node, slot] = True
        pending[node, slot] = True
        return RumorState(store=store, pending=pending)

    def coverage(self, state, alive: torch.Tensor, slot: int
                 ) -> torch.Tensor:
        have = state.store[:, slot] & alive
        return have.sum().to(torch.float32) / torch.clamp(
            alive.sum(), min=1).to(torch.float32)
