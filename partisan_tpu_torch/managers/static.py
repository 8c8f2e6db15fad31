"""Static peer-service manager (port of
``partisan_tpu/managers/static.py``): membership changes only by explicit
join/leave — no gossip, no overlay maintenance.  A join connects both
ends; crash-stopped peers keep their slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch.ops import msg as msg_ops


class StaticState(NamedTuple):
    joined: torch.Tensor  # bool[n, n_global] — established connections


def dense_neighbors(joined: torch.Tensor) -> torch.Tensor:
    """int32[n, n_global]: the peer's id where connected, else -1."""
    ids = torch.arange(joined.shape[1], dtype=torch.int32,
                       device=joined.device)
    return torch.where(joined, ids[None, :], -1)


def self_rows(n: int, gids: torch.Tensor, n_global: int) -> torch.Tensor:
    """bool[n, n_global]: True at each row's own id."""
    ids = torch.arange(n_global, dtype=torch.int32, device=gids.device)
    return ids[None, :] == gids[:, None]


def link(joined: torch.Tensor, a: int, b: int, value: bool = True
         ) -> torch.Tensor:
    """``joined`` with the a<->b connection set (both directions)."""
    j = joined.clone()
    j[a, b] = value
    j[b, a] = value
    return j


class Static:
    name = "static"

    def init(self, cfg, comm) -> StaticState:
        return StaticState(joined=torch.zeros(
            (comm.n_local, comm.n_global), dtype=torch.bool,
            device=comm.device))

    def step(self, cfg, comm, state: StaticState, ctx):
        return state, msg_ops.zero_stack(cfg, (comm.n_local, 0),
                                         device=state.joined.device)

    def neighbors(self, cfg, state: StaticState, comm=None) -> torch.Tensor:
        return dense_neighbors(state.joined)

    def members(self, cfg, state: StaticState, comm=None) -> torch.Tensor:
        n, n_global = state.joined.shape
        gids = comm.local_ids() if comm is not None else torch.arange(
            n, dtype=torch.int32, device=state.joined.device)
        return state.joined | self_rows(n, gids, n_global)

    # ---- scenario scripting (host-side) ------------------------------
    def join(self, cfg, state: StaticState, node: int, target: int
             ) -> StaticState:
        return StaticState(joined=link(state.joined, node, target))

    def leave(self, cfg, state: StaticState, node: int) -> StaticState:
        j = state.joined.clone()
        j[node, :] = False
        j[:, node] = False
        return StaticState(joined=j)
