"""Client-server (star) peer-service manager (port of
``partisan_tpu/managers/client_server.py``).

The first ``cfg.cs_servers`` global ids are servers, the rest clients.
Joins connect server-server and client-server pairs and refuse
client-client ones; on the periodic tick each node pushes its member
bitmap along its connections, so every ``members`` row converges on the
full roster.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import faults as faults_mod
from partisan_tpu_torch.managers.static import (dense_neighbors, link,
                                                 self_rows)
from partisan_tpu_torch.ops import msg as msg_ops

_GOSSIP_EDGE_TAG = 111


class ClientServerState(NamedTuple):
    joined: torch.Tensor  # bool[n, n_global] — established connections
    known: torch.Tensor   # bool[n, n_global] — gossiped membership view


class ClientServer:
    name = "client_server"

    def init(self, cfg, comm) -> ClientServerState:
        n, g = comm.n_local, comm.n_global
        return ClientServerState(
            joined=torch.zeros((n, g), dtype=torch.bool, device=comm.device),
            known=self_rows(n, comm.local_ids(), g))

    def step(self, cfg, comm, state: ClientServerState, ctx):
        gids = comm.local_ids()
        fires = ((ctx.rnd + gids) % cfg.gossip_every == 0) & ctx.alive
        dst = torch.where(fires[:, None], dense_neighbors(state.joined), -1)
        dst = faults_mod.filter_edges(ctx.faults, gids, dst, ctx.seed,
                                      ctx.rnd, _GOSSIP_EDGE_TAG)
        pushed = comm.push_or(state.known, dst)
        alive = ctx.alive[:, None]
        known = torch.where(alive, state.known | (pushed & alive),
                            state.known)
        return ClientServerState(joined=state.joined, known=known), \
            msg_ops.zero_stack(cfg, (comm.n_local, 0), device=gids.device)

    # ---- views -------------------------------------------------------
    def neighbors(self, cfg, state: ClientServerState, comm=None
                  ) -> torch.Tensor:
        return dense_neighbors(state.joined)

    def members(self, cfg, state: ClientServerState, comm=None
                ) -> torch.Tensor:
        return state.known

    # ---- scenario scripting (host-side) ------------------------------
    def join(self, cfg, state: ClientServerState, node: int, target: int
             ) -> ClientServerState:
        """Refused between two clients (the state comes back as it was)."""
        if node >= cfg.cs_servers and target >= cfg.cs_servers:
            return state
        return ClientServerState(joined=link(state.joined, node, target),
                                 known=link(state.known, node, target))

    def leave(self, cfg, state: ClientServerState, node: int
              ) -> ClientServerState:
        j = state.joined.clone()
        j[node, :] = False
        j[:, node] = False
        k = state.known.clone()
        k[:, node] = False
        k[node, :] = False
        k[node, node] = True
        return ClientServerState(joined=j, known=k)
