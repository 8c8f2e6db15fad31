"""Communication substrate on one device (port of ``partisan_tpu/comm.py``).

``LocalComm`` gives managers and models the two batched primitives they
program against — ``route`` (event records into inboxes) and
``push_max`` (monotonic state merge) — with every node on one device.
The cross-shard reductions (``allsum``, ``allmax``, ``allmin``,
``gather_vec``) and ``local`` (a shard's rows of a replicated per-node
vector) are identities here; ``actor_gather`` slices the causal actor
block.  ``parallel/sharded.ShardComm`` runs the same interface on one
shard of a mesh.

The round treats what it is handed as read-only: it writes in place
neither into a leaf of the state it steps (the flight ring, copied once
per call, excepted) nor into what a collective returns (here the
argument itself).  ``ShardedCluster`` hands its shards views of one
global state, so it checks the first rule after every call.
"""

from __future__ import annotations

import dataclasses

import torch

from partisan_tpu_torch.ops import exchange, gossip


@dataclasses.dataclass(frozen=True)
class LocalComm:
    n_global: int
    inbox_cap: int
    msg_words: int
    device: torch.device = torch.device("cpu")

    @property
    def n_local(self) -> int:
        return self.n_global

    @property
    def node_offset(self) -> int:
        return 0

    def local_ids(self) -> torch.Tensor:
        return torch.arange(self.n_global, dtype=torch.int32,
                            device=self.device)

    def local(self, x):
        """This shard's rows of a replicated per-node tensor (all of
        them here; ``ShardComm`` slices its range)."""
        return x

    def route(self, emitted) -> exchange.Inbox:
        return exchange.route(emitted, self.n_global, self.inbox_cap)

    def push_max(self, rows: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return gossip.push_max(rows, dst, n_out=self.n_global)

    def push_or(self, rows: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return gossip.push_or(rows, dst, n_out=self.n_global)

    def allsum(self, x):
        return x

    def allmax(self, x):
        return x

    def allmin(self, x):
        """Elementwise on arrays (the health plane's label proposals)."""
        return x

    def actor_gather(self, x, a: int):
        """Rows of ``x`` (a record stack) for nodes 0..a-1, the causal
        actor space."""
        if a > self.n_local:
            raise ValueError(
                f"n_actors={a} must be <= nodes per shard ({self.n_local})")
        return x.map(lambda w: w[:a])

    def gather_vec(self, x):
        return x
