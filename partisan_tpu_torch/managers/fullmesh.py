"""Full-mesh manager + full membership strategy (port of
``partisan_tpu/managers/fullmesh.py``).

State is one OR-set view per node (``ops/orset.py``).  A periodic gossip
tick pushes the node's whole view to every peer it believes is a member
and merges by elementwise max — one scatter-max per round.  Each node's
timer fires at ``(round + node_id) % gossip_every == 0``; a join or
leave marks the node urgent, so it gossips next round regardless.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import orset

_GOSSIP_EDGE_TAG = 101  # fault-hash call-site salt for gossip edges


class FullMeshState(NamedTuple):
    view: torch.Tensor    # int64[n, 2, n] — OR-set views (uint32 values)
    urgent: torch.Tensor  # bool[n] — gossip next round regardless of phase


class FullMesh:
    name = "fullmesh"

    def init(self, cfg, comm) -> FullMeshState:
        return FullMeshState(
            view=orset.fresh_views(comm.n_global, device=comm.device),
            urgent=torch.zeros(comm.n_local, dtype=torch.bool,
                               device=comm.device))

    def _peers(self, state: FullMeshState, comm) -> torch.Tensor:
        """int32[n, n]: member ids other than the node itself, -1 else."""
        gids = comm.local_ids()
        all_ids = torch.arange(state.view.shape[2], dtype=torch.int32,
                               device=gids.device)
        peer = orset.members(state.view) & (all_ids[None, :]
                                            != gids[:, None])
        return torch.where(peer, all_ids[None, :], -1)

    def step(self, cfg, comm, state: FullMeshState, ctx):
        n_local, _, n_global = state.view.shape
        gids = comm.local_ids()
        every = cfg.gossip_every
        fires = ((ctx.rnd + gids % every) % every == 0) | state.urgent
        fires = fires & ctx.alive
        dst = torch.where(fires[:, None], self._peers(state, comm), -1)
        dst = faults_mod.filter_edges(ctx.faults, gids, dst, ctx.seed,
                                      ctx.rnd, _GOSSIP_EDGE_TAG)
        pushed = comm.push_max(state.view.reshape(n_local, 2 * n_global),
                               dst).reshape(n_local, 2, n_global)
        merged = orset.merge(state.view, pushed)
        # Crashed nodes are frozen, their pending-urgent flag included.
        view = torch.where(ctx.alive[:, None, None], merged, state.view)
        urgent = state.urgent & ~ctx.alive
        emitted = msg_ops.zero_stack(cfg, (n_local, 0), device=gids.device)
        return FullMeshState(view=view, urgent=urgent), emitted

    # ---- views -------------------------------------------------------
    def neighbors(self, cfg, state: FullMeshState, comm) -> torch.Tensor:
        return self._peers(state, comm)

    def members(self, cfg, state: FullMeshState, comm=None) -> torch.Tensor:
        return orset.members(state.view)

    # ---- scenario scripting (host-side) ------------------------------
    def _set_row(self, state: FullMeshState, node: int, row,
                 urgent: bool) -> FullMeshState:
        view = state.view.clone()
        view[node] = row
        flag = state.urgent.clone()
        if urgent:
            flag[node] = True
        return FullMeshState(view=view, urgent=flag)

    def join(self, cfg, state: FullMeshState, node: int,
             target: int) -> FullMeshState:
        """``node`` joins via ``target``: it learns the target's current
        incarnation and gossips urgently."""
        inc = torch.clamp(state.view[target, 0, target], min=1)
        return self._set_row(state, node,
                             orset.add(state.view[node], target, inc), True)

    def leave(self, cfg, state: FullMeshState, node: int) -> FullMeshState:
        """Graceful leave: observed-remove own spec + urgent gossip."""
        return self._set_row(state, node,
                             orset.remove(state.view[node], node), True)

    def rejoin(self, cfg, state: FullMeshState, node: int,
               target: int) -> FullMeshState:
        """Rejoin after a leave under a fresh incarnation."""
        inc = state.view[node, 0, node] + 1
        st = self._set_row(state, node,
                           orset.add(state.view[node], node, inc), False)
        return self.join(cfg, st, node, target)
