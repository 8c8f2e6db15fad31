"""Demers anti-entropy broadcast (port of
``partisan_tpu/models/anti_entropy.py``).

Every ``INTERVAL_MS`` each node picks ``FANOUT`` random neighbors and
pushes its whole message store; the receivers answer the AE_PULL event
message it also sends by pushing their stores back next round.  The
store is a seen-bitmap ``bool[n, max_broadcasts]`` riding the
state-gossip lane (``comm.push_or``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import rng

FANOUT = 2                 # demers_anti_entropy.erl:42 ?FANOUT
INTERVAL_MS = 2_000        # :118 anti-entropy timer
OP_PULL = 1                # APP payload[0] opcode

_FANOUT_TAG = 201
_PUSH_EDGE_TAG = 202
_PULL_EDGE_TAG = 203


class AntiEntropyState(NamedTuple):
    store: torch.Tensor  # bool[n, max_broadcasts]


def pick_neighbors(keys: torch.Tensor, nbrs: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """int32[..., k]: ``k`` random valid entries of each neighbor row
    (``nbrs[n, K]``, keys ``[n, ..., 2]``), -1 where fewer exist."""
    lead = keys.shape[:-1]
    valid = (nbrs >= 0).reshape(nbrs.shape[:1] + (1,) * (len(lead) - 1)
                                + nbrs.shape[1:]).expand(lead + nbrs.shape[1:])
    slots = rng.choice_slots(keys, valid, k)
    rows = nbrs.reshape(valid.shape[:1] + (1,) * (len(lead) - 1)
                        + nbrs.shape[1:]).expand(valid.shape)
    got = rows.gather(-1, slots.clamp(min=0).to(torch.int64))
    return torch.where(slots >= 0, got, -1)


class AntiEntropy:
    name = "demers_anti_entropy"

    def init(self, cfg, comm) -> AntiEntropyState:
        return AntiEntropyState(store=torch.zeros(
            (comm.n_local, cfg.max_broadcasts), dtype=torch.bool,
            device=comm.device))

    def step(self, cfg, comm, state: AntiEntropyState, ctx, nbrs):
        gids = comm.local_ids()
        every = cfg.rounds(INTERVAL_MS)
        fires = ((ctx.rnd + gids) % every == 0) & ctx.alive
        targets = pick_neighbors(rng.subkey(ctx.keys, _FANOUT_TAG), nbrs,
                                 FANOUT)
        targets = torch.where(fires[:, None], targets, -1)
        push_dst = faults_mod.filter_edges(ctx.faults, gids, targets,
                                           ctx.seed, ctx.rnd,
                                           _PUSH_EDGE_TAG)

        # pull replies for last round's AE_PULL requests
        inb = ctx.inbox.data
        is_pull = (inb[T.W_KIND] == T.MsgKind.APP) & (inb[T.P0] == OP_PULL)
        pull_dst = torch.where(is_pull & ctx.alive[:, None], inb[T.W_SRC],
                               -1)
        pull_dst = faults_mod.filter_edges(ctx.faults, gids, pull_dst,
                                           ctx.seed, ctx.rnd,
                                           _PULL_EDGE_TAG)

        pushed = comm.push_or(state.store,
                              torch.cat([push_dst, pull_dst], dim=1))
        store = state.store | (pushed & ctx.alive[:, None])
        emitted = msg_ops.build(cfg, T.MsgKind.APP, gids[:, None], targets,
                                payload=(OP_PULL,))
        return AntiEntropyState(store=store), emitted

    # ---- scenario helpers --------------------------------------------
    def broadcast(self, state: AntiEntropyState, node: int, slot: int
                  ) -> AntiEntropyState:
        store = state.store.clone()
        store[node, slot] = True
        return AntiEntropyState(store=store)

    def coverage(self, state, alive: torch.Tensor, slot: int
                 ) -> torch.Tensor:
        """Fraction of alive nodes holding ``slot`` (float32 scalar)."""
        have = state.store[:, slot] & alive
        return have.sum().to(torch.float32) / torch.clamp(
            alive.sum(), min=1).to(torch.float32)
