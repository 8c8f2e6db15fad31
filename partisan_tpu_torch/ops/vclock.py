"""Vector clocks as dense vectors (port of ``partisan_tpu/ops/vclock.py``).

A clock is a dense vector of ``n_actors`` counters (the Riak-style
vclock API of partisan_vclock: ``fresh/increment/merge/descends/
dominates/glb``): merge is the elementwise max, descends an all-``>=``
reduction, increment a one-hot add; whole matrices of clocks (one row
per node) merge in one op.

The reference keeps the counters as uint32.  Torch has no uint32 max,
compare or scatter on the CPU, so the port holds the same values in
int64 in ``[0, 2**32)`` on both devices (as ``ops/orset.py`` does), and
every add wraps with the ``0xFFFFFFFF`` mask; ``state_io`` hands the
clocks across as uint32 numpy leaves.
"""

from __future__ import annotations

import torch

DTYPE = torch.int64   # uint32 values held in int64
MASK32 = 0xFFFFFFFF


def fresh(n_actors: int, device=None) -> torch.Tensor:
    """The zero clock."""
    return torch.zeros(n_actors, dtype=DTYPE, device=device)


def fresh_matrix(n_nodes: int, n_actors: int, device=None) -> torch.Tensor:
    """One fresh clock per node: ``[n_nodes, n_actors]``."""
    return torch.zeros((n_nodes, n_actors), dtype=DTYPE, device=device)


def increment(vc: torch.Tensor, actor) -> torch.Tensor:
    """Bump one actor's counter (``actor`` a scalar, or ``[..., 1]`` for
    one per row)."""
    onehot = torch.arange(vc.shape[-1], device=vc.device) == \
        torch.as_tensor(actor, device=vc.device)
    return (vc + onehot.to(DTYPE)) & MASK32


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise elementwise max (broadcasts)."""
    return torch.maximum(a, b)


def descends(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True iff ``a >= b`` pointwise, over the trailing actor axis."""
    return (a >= b).all(dim=-1)


def dominates(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Strict descent."""
    return descends(a, b) & (a > b).any(dim=-1)


def concurrent(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Neither descends the other."""
    return ~descends(a, b) & ~descends(b, a)


def glb(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Greatest lower bound (elementwise min)."""
    return torch.minimum(a, b)


def get_counter(vc: torch.Tensor, actor) -> torch.Tensor:
    """The counter of ``actor`` (a scalar or one per row)."""
    idx = torch.as_tensor(actor, device=vc.device).to(torch.int64)
    idx = idx.expand(vc.shape[:-1])[..., None]
    return torch.gather(vc, -1, idx)[..., 0]


def deliverable(msg_clock: torch.Tensor, local: torch.Tensor,
                sender) -> torch.Tensor:
    """The causal-delivery gate: ``msg_clock[sender] == local[sender] +
    1`` and ``msg_clock[k] <= local[k]`` for every other k."""
    sender = torch.as_tensor(sender, device=local.device)
    onehot = torch.arange(local.shape[-1], device=local.device) == \
        sender[..., None]
    nxt = torch.where(onehot, (local + 1) & MASK32, local)
    return (msg_clock <= nxt).all(dim=-1) & (
        get_counter(msg_clock, sender)
        == (get_counter(local, sender) + 1) & MASK32)
