"""Struct-of-planes message records: the plane-major wire layout.

Port of ``partisan_tpu/ops/plane.py``.  A record stack of logical shape
``[..., W]`` is a :class:`Planes` — a tuple of W word tensors, each of
the record shape and its word's narrow storage dtype.  ``p[i]`` is word
plane ``i``.  Records stay planes from emission through compaction, the
wire filter and the route; they widen to the int32 ``[..., W]`` wire
layout only at :func:`interleave`, which the round calls once, when it
captures the send trace.

The interleave kernel
---------------------
:func:`interleave` replaces the TPU kernel ``interleave_kernel``
(tools/pallas_probe.py:54) and its XLA twin ``Planes.interleave``
(partisan_tpu/ops/plane.py:167).  On a CUDA tensor it launches the
hand-written kernel in ``csrc/interleave.cu`` or raises; on a CPU tensor
it runs :func:`interleave_plain`, the plain PyTorch version the tests
hold against the reference.  The kernel is bound by bytes: each record
reads its planes' storage bytes once and writes ``4 * W`` bytes
(at the main path's capture shape, 53 B in and 64 B out per record).
Design: a persistent grid walks tiles of 512 records; each plane's run
of a tile arrives by one bulk async copy into a 3-stage ring in shared
memory, so the next tiles load while one is transposed and written as
coalesced 16-byte stores; see the source's header.  The host path is
lean: :func:`interleave_args` checks the planes and looks up their size
code by dtypes, the plane pointers travel as one packed bytes object, and
:func:`partisan_tpu_torch.kernels.launch` makes one ctypes call.
"""

from __future__ import annotations

import struct
from typing import Sequence

import torch

from partisan_tpu_torch import kernels


class Planes(tuple):
    """A record stack stored as a tuple of W word planes."""

    __slots__ = ()

    def __new__(cls, ws):
        return super().__new__(cls, tuple(ws))

    def map(self, fn) -> "Planes":
        """Apply ``fn`` to every plane (record-axis indexing/reshape)."""
        return Planes(fn(w) for w in self)

    def __repr__(self) -> str:
        return (f"Planes(shape={tuple(self[0].shape) + (len(self),)}, "
                f"dtypes={[str(w.dtype) for w in self]})")


def set_word(p: Planes, i: int, v) -> Planes:
    """Replace word plane ``i`` with ``v`` (cast to its storage dtype and
    broadcast to the record shape)."""
    w = p[i]
    v = torch.as_tensor(v, device=w.device).to(w.dtype).expand(w.shape)
    return Planes(p[:i] + (v,) + p[i + 1:])


def blocks_of(x) -> list:
    """Emission blocks of a manager/model ``step`` result (a tuple of
    blocks, or a single stack)."""
    return list(x) if isinstance(x, list) or (
        isinstance(x, tuple) and not isinstance(x, Planes)) else [x]


def concat(blocks: Sequence[Planes], dim: int = 1) -> Planes:
    """Concatenate record blocks on a record axis, per plane."""
    blocks = list(blocks)
    return Planes(torch.cat([b[i] for b in blocks], dim=dim)
                  for i in range(len(blocks[0])))


def where(mask: torch.Tensor, a, b) -> Planes:
    """Record-granular select; either side may be a scalar."""
    ref = a if isinstance(a, Planes) else b
    aw = a if isinstance(a, Planes) else [a] * len(ref)
    bw = b if isinstance(b, Planes) else [b] * len(ref)
    return Planes(torch.where(mask, torch.as_tensor(x, device=w.device)
                              .to(w.dtype), torch.as_tensor(
                                  y, device=w.device).to(w.dtype))
                  for w, x, y in zip(ref, aw, bw))


def zero_planes(shape: tuple, dtypes: Sequence, device=None) -> Planes:
    """All-empty records, one zero plane per word at its storage dtype."""
    return Planes(torch.zeros(tuple(shape), dtype=dt, device=device)
                  for dt in dtypes)


def stack_words(p: Planes, lo: int = 0, hi: int | None = None
                ) -> torch.Tensor:
    """A contiguous word block as one int32 array ``[..., hi-lo]`` (a few
    payload words, not the full record)."""
    ws = p[lo:hi] if hi is not None else p[lo:]
    return torch.stack([w.to(torch.int32) for w in ws], dim=-1)


def append_tail(p: Planes, arr: torch.Tensor) -> Planes:
    """Append ``arr [..., K]``'s minor-axis slices as K trailing int32
    word planes (the causal lanes' vector-clock block; values at or
    above 2**31 wrap to their int32 bit pattern)."""
    arr = torch.where(arr >= 2 ** 31, arr - 2 ** 32, arr)
    return Planes(tuple(p) + tuple(arr[..., i].to(torch.int32)
                                   for i in range(arr.shape[-1])))


def append_words(p: Planes, *words) -> Planes:
    """Widen a record stack with trailing word planes (the latency birth
    round, the provenance pair), each broadcast to the record shape and
    materialized: a stamped plane is as contiguous as the ones it joins,
    so the interleave kernel takes it as it is."""
    shape = p[0].shape
    return Planes(tuple(p) + tuple(
        torch.as_tensor(w, device=p[0].device).expand(shape).contiguous()
        for w in words))


def stack_records(blocks: Sequence[Planes], dim: int = 0) -> Planes:
    """``torch.stack`` over whole records (a new record axis, not the
    word axis)."""
    blocks = list(blocks)
    return Planes(torch.stack([b[i] for b in blocks], dim=dim)
                  for i in range(len(blocks[0])))


def take_along(p: Planes, idx: torch.Tensor, dim: int) -> Planes:
    """Per-plane ``take_along_axis`` over a record axis."""
    return Planes(torch.gather(w, dim, idx) for w in p)


def take_flat(p: Planes, pos: torch.Tensor, *, fill: bool = False
              ) -> Planes:
    """Gather whole records out of a flat ``[m]`` stack by ``pos``; with
    ``fill`` out-of-range positions give all-zero records."""
    m = p[0].shape[0]
    if not fill:
        return Planes(w[pos] for w in p)
    ok = (pos >= 0) & (pos < m)
    safe = torch.where(ok, pos, 0)
    return Planes(torch.where(ok, w[safe], 0).to(w.dtype) for w in p)


def take_rows(p: Planes, idx: torch.Tensor, *, fill: bool = False
              ) -> Planes:
    """``out[i, j] = p[i, idx[i, j]]`` over an ``[n, E]`` stack.  A
    negative index wraps one turn; with ``fill`` entries still out of
    range give all-zero records, without it they clamp into the row."""
    E = p[0].shape[1]
    w_idx = torch.where(idx < 0, idx + E, idx)
    if fill:
        ok = (w_idx >= 0) & (w_idx < E)
        safe = torch.where(ok, w_idx, 0).to(torch.int64)
        return Planes(torch.where(ok, torch.gather(w, 1, safe), 0)
                      .to(w.dtype) for w in p)
    safe = w_idx.clamp(0, E - 1).to(torch.int64)
    return Planes(torch.gather(w, 1, safe) for w in p)


def scatter_rows(p: Planes, idx: torch.Tensor, src: Planes) -> Planes:
    """``out[i, idx[i, j]] = src[i, j]`` into an ``[n, C]`` stack; an
    index of ``C`` drops its record.  The kept indices of a row must be
    distinct (then the result is the same on every device)."""
    C = p[0].shape[1]
    idx = idx.to(torch.int64)
    out = []
    for w, s in zip(p, src):
        pad = torch.cat([w, w.new_zeros((w.shape[0], 1))], dim=1)
        out.append(pad.scatter_(1, idx, s.to(w.dtype))[:, :C])
    return Planes(out)


# ---------------------------------------------------------------------------
# The plane->wire interleave
# ---------------------------------------------------------------------------

MAX_PLANES = 32
_SIZE_LOG2 = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
# dtypes of the planes -> (size code, packer of the plane pointers); the
# wire dtypes are fixed per Config, so a run meets a handful of keys
_PLANS: dict = {}


def interleave_plain(ws: Sequence[torch.Tensor], out=None) -> torch.Tensor:
    """The plain PyTorch version: one ``torch.stack`` on a new minor axis
    (it promotes the narrow planes to their widest dtype, which is int32
    whenever one plane is; the final cast covers the rest)."""
    if out is not None:
        return torch.stack(list(ws), dim=-1, out=out)
    return torch.stack(list(ws), dim=-1).to(torch.int32)


def interleave(p, out=None) -> torch.Tensor:
    """Planes -> int32 wire tensor ``[..., W]``, written into ``out`` when
    given.  CPU planes take the plain version; CUDA planes go through the
    kernel (or raise)."""
    ws = tuple(p)
    if ws[0].is_cuda:
        return interleave_cuda(ws, out=out)
    if any(w.device.type != "cpu" for w in ws):
        raise ValueError("interleave: planes must all lie on the CPU or "
                         f"all on one CUDA device, got {ws[0].device} first")
    return interleave_plain(ws, out=out)


def size_plan(dtypes: tuple) -> tuple:
    """``(size code, pointer packer)`` for planes of ``dtypes``: the code
    holds 2 bits per plane, log2 of its element size, plane 0 in the
    lowest bits; the packer is a ``struct.Struct`` of W native pointers.
    Raises ``TypeError`` on a dtype the kernel does not take."""
    plan = _PLANS.get(dtypes)
    if plan is None:
        code = 0
        for i, dt in enumerate(dtypes):
            if dt not in _SIZE_LOG2:
                raise TypeError(f"interleave kernel: unsupported dtype {dt}")
            code |= _SIZE_LOG2[dt] << (2 * i)
        plan = _PLANS[dtypes] = (code, struct.Struct(f"{len(dtypes)}P"))
    return plan


def interleave_args(ws: Sequence[torch.Tensor], out=None) -> tuple:
    """Check planes (and ``out``) for the kernel and return ``(records,
    size code, pointer packer)``.  Planes must share one device and one
    shape and be contiguous; ``out``, when given, must be a contiguous
    int32 ``[..., W]`` tensor on their device.  Anything else raises
    ``ValueError`` (or ``TypeError`` for a plane dtype)."""
    W = len(ws)
    if not 1 <= W <= MAX_PLANES:
        raise ValueError(f"interleave kernel takes 1..{MAX_PLANES} planes, "
                         f"got {W}")
    w0 = ws[0]
    shape, dev = w0.shape, w0.device
    dtypes = []
    for w in ws:
        if w.shape != shape or w.device != dev:
            raise ValueError("interleave kernel: planes must share one "
                             "device and one shape")
        if not w.is_contiguous():
            raise ValueError("interleave kernel: planes must be contiguous")
        dtypes.append(w.dtype)
    code, packer = size_plan(tuple(dtypes))
    if out is not None and (
            out.dtype != torch.int32 or out.device != dev
            or out.shape != shape + (W,) or not out.is_contiguous()):
        raise ValueError("interleave kernel: out must be a contiguous "
                         f"int32 tensor of shape {tuple(shape) + (W,)} on "
                         f"{dev}")
    return w0.numel(), code, packer


def interleave_cuda(ws: Sequence[torch.Tensor], out=None) -> torch.Tensor:
    """Launch ``csrc/interleave.cu`` on CUDA planes, into ``out`` (a
    contiguous int32 ``[..., W]`` tensor) or a new tensor."""
    m, code, packer = interleave_args(ws, out)
    w0 = ws[0]
    if not w0.is_cuda:
        raise ValueError(f"interleave kernel: planes on {w0.device}, not "
                         "a CUDA device")
    if out is None:
        out = w0.new_empty((*w0.shape, len(ws)), dtype=torch.int32)
    if m:
        kernels.launch("interleave", w0.get_device(),
                       packer.pack(*[w.data_ptr() for w in ws]), code,
                       len(ws), m, out.data_ptr())
    return out
