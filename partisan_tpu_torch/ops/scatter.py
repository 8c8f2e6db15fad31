"""Scatters into ``[n, width]`` state from an ``[n, cap]`` inbox, with a
drop column for masked-out messages, that give the same result on every
device (port of the reference's ``.at[rows, idx].set/max(mode="drop")``
call sites in the app models).

- ``fold_true``: every write carries True, so the order of duplicate
  writes does not matter.
- ``last_writer`` / ``take_last``: writes that carry values pick their
  winner explicitly, the LAST inbox slot addressing a column, as the
  reference's CPU scatter applies its updates in order (CUDA's
  ``index_put_`` has no defined winner among duplicates).
- ``reduce_drop``: writes combined by an order-free max or min.
- ``set_at``: the host-side scripting write, on a copy (a state is
  never written in place: booted states are reused across runs).
"""

from __future__ import annotations

import torch


def set_at(t: torch.Tensor, idx, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[idx] = value``."""
    out = t.clone()
    out[idx] = value
    return out


def fold_true(bits: torch.Tensor, idx: tuple, dim: int = -1
              ) -> torch.Tensor:
    """A copy of ``bits`` with ``bits[idx] = True``, where an index equal
    to ``bits.shape[dim]`` on axis ``dim`` drops its write."""
    dim %= bits.dim()
    shape = list(bits.shape)
    shape[dim] = 1
    pad = torch.cat([bits, bits.new_zeros(shape)], dim=dim)
    pad.index_put_(tuple(i.to(torch.int64) for i in idx),
                   torch.ones((), dtype=torch.bool, device=bits.device))
    return pad.narrow(dim, 0, bits.shape[dim])


def reduce_drop(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                reduce: str) -> torch.Tensor:
    """``base.at[rows, idx].max/min(src, mode="drop")`` over ``[n,
    width]`` (``reduce`` "amax" or "amin"), where a column index equal
    to ``width`` drops its write."""
    n, width = base.shape
    pad = torch.cat([base, base.new_zeros((n, 1))], dim=1)
    return pad.scatter_reduce(1, idx.to(torch.int64), src.to(base.dtype),
                              reduce, include_self=True)[:, :width]


def last_writer(idx: torch.Tensor, m: torch.Tensor, width: int
                ) -> torch.Tensor:
    """int64[n, width]: for each column the LAST inbox slot ``j`` with
    ``m[row, j]`` and ``idx[row, j] == column``, or -1 (the flat inbox
    index scatter-maxed onto a drop column)."""
    n, cap = m.shape
    j = torch.arange(cap, device=m.device).expand(n, cap)
    tgt = torch.where(m, idx.to(torch.int64), width)
    return torch.full((n, width + 1), -1, dtype=torch.int64,
                      device=m.device).scatter_reduce_(
        1, tgt, j, "amax")[:, :width]


def take_last(dest: torch.Tensor, win: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """``dest`` with each column that has a writer in ``win`` set to that
    inbox slot's value of ``v`` ([n, cap])."""
    got = torch.gather(v.to(dest.dtype), 1, win.clamp(min=0))
    return torch.where(win >= 0, got, dest)
