"""Membership set: a rank-reduced OR-set over node ids (port of
``partisan_tpu/ops/orset.py``).

Each node's view holds two counters per member — ``add[j]``, the highest
incarnation of j seen joining, and ``rm[j]``, the highest seen leaving —
with ``member(j) = add[j] > rm[j]`` and merge = elementwise max.  A
node view is ``[2, n]`` (stacked add/rm), a cluster's views ``[n, 2, n]``.

The reference stores the counters as uint32.  Torch has no uint32 max,
compare or scatter-max on the CPU, so the port holds the same values in
int64 on both devices (one code path); ``state_io`` hands them across as
uint32 numpy leaves both ways.
"""

from __future__ import annotations

import torch

DTYPE = torch.int64   # uint32 values held in int64


def fresh_views(n: int, device=None) -> torch.Tensor:
    """Every node starts knowing only itself at incarnation 1."""
    add = torch.eye(n, dtype=DTYPE, device=device)
    return torch.stack([add, torch.zeros_like(add)], dim=1)   # [n, 2, n]


def members(view: torch.Tensor) -> torch.Tensor:
    """bool mask of live members in a view ``[..., 2, n]``."""
    return view[..., 0, :] > view[..., 1, :]


def add(view: torch.Tensor, member: int, incarnation=1) -> torch.Tensor:
    """Observe ``member`` joining at ``incarnation`` (max-merge)."""
    onehot = torch.arange(view.shape[-1], device=view.device) == member
    inc = torch.as_tensor(incarnation, dtype=DTYPE, device=view.device)
    bumped = torch.maximum(view[..., 0, :], torch.where(onehot, inc, 0))
    return torch.stack([bumped, view[..., 1, :]], dim=-2)


def remove(view: torch.Tensor, member: int) -> torch.Tensor:
    """Observed-remove: delete every incarnation of ``member`` this view
    has seen."""
    onehot = torch.arange(view.shape[-1], device=view.device) == member
    newrm = torch.where(onehot, torch.maximum(view[..., 1, :],
                                              view[..., 0, :]),
                        view[..., 1, :])
    return torch.stack([view[..., 0, :], newrm], dim=-2)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CRDT join — elementwise max over both planes."""
    return torch.maximum(a, b)
