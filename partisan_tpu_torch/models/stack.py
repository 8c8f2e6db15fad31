"""Model composition: several per-node services in one cluster (port of
``partisan_tpu/models/stack.py``).

A ``Stack`` of models shares one node axis and one inbox: each model
reads the whole inbox (filtering by its own message kinds, like
registered-process dispatch) and their emissions are concatenated onto
the wire.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from partisan_tpu_torch.ops import plane as plane_ops


class Stack:
    """Composite model; its state is a tuple of sub-states."""

    def __init__(self, models: Sequence[Any]) -> None:
        self.models = tuple(models)
        self.name = "+".join(getattr(m, "name", type(m).__name__)
                             for m in self.models)

    def init(self, cfg, comm) -> tuple:
        return tuple(m.init(cfg, comm) for m in self.models)

    def step(self, cfg, comm, state: tuple, ctx, nbrs):
        outs, emits = [], []
        for m, s in zip(self.models, state):
            s2, e = m.step(cfg, comm, s, ctx, nbrs)
            outs.append(s2)
            emits += plane_ops.blocks_of(e)
        return tuple(outs), tuple(emits)

    def coverage(self, state: tuple, alive: torch.Tensor, slot: int = 0):
        """Coverage of the first sub-model that defines one; 1.0 when
        none does."""
        for m, s in zip(self.models, state):
            if hasattr(m, "coverage"):
                return m.coverage(s, alive, slot)
        return torch.tensor(1.0, dtype=torch.float32)

    # Host-side helpers address sub-models by index.
    def sub(self, state: tuple, i: int):
        return state[i]

    def replace_sub(self, state: tuple, i: int, sub_state) -> tuple:
        return state[:i] + (sub_state,) + state[i + 1:]
