"""Building fixed-width message records (port of ``partisan_tpu/ops/msg.py``).

A freshly built stack is a :class:`~partisan_tpu_torch.ops.plane.Planes`:
one tensor per wire word at its storage dtype, no interleave.  Constant
words are broadcast views (``expand``), materialized by the round's one
emission concatenate.
"""

from __future__ import annotations

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import plane as plane_ops


def _device(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("build needs at least one tensor argument")


def build(cfg, kind, src, dst, *, channel=0, ttl=0, clock=0, lane=0,
          flags=0, payload: tuple = ()) -> plane_ops.Planes:
    """Records of shape broadcast(src, dst, ...) + [msg_words].  A record
    whose ``dst`` is negative is empty (kind NONE, dst 0)."""
    msg_words = cfg.msg_words
    if len(payload) > msg_words - T.HDR_WORDS:
        raise ValueError(
            f"{len(payload)} payload words exceed msg_words={msg_words}")
    dev = _device(dst, src, kind, *payload)
    args = [torch.as_tensor(x, device=dev) for x in
            (kind, src, dst, channel, ttl, clock, lane, flags, *payload)]
    shape = torch.broadcast_shapes(*(a.shape for a in args))
    dst = args[2].to(torch.int32).expand(shape)
    valid = dst >= 0

    def w(x, i):
        return x.to(T.wire_dtype(i)).expand(shape)

    words = [torch.where(valid, w(args[0], T.W_KIND), 0), w(args[1], T.W_SRC),
             torch.where(valid, dst, 0)]
    words += [w(args[i], i) for i in range(T.W_CHANNEL, T.HDR_WORDS)]
    words += [w(p, T.HDR_WORDS + i) for i, p in enumerate(args[8:])]
    words += [torch.zeros((), dtype=T.wire_dtype(i), device=dev).expand(shape)
              for i in range(len(words), msg_words)]
    return plane_ops.Planes(words)


def zero_stack(cfg, shape: tuple, device=None) -> plane_ops.Planes:
    """An all-empty ``msg_words``-wide emission block of record shape
    ``shape``."""
    return plane_ops.zero_planes(
        tuple(shape), tuple(T.wire_dtype(i) for i in range(cfg.msg_words)),
        device=device)


def zero_wire(cfg, shape: tuple, device=None) -> plane_ops.Planes:
    """An all-empty wire-width record block, for queued-copy buffers (the
    ack store, the delay stage's hold buffer): ``wire_words`` planes,
    the provenance pair and the birth round included."""
    return plane_ops.zero_planes(tuple(shape), cfg.wire_dtypes,
                                 device=device)
