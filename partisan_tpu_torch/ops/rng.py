"""Deterministic per-node randomness: counter hashes and threefry keys.

Port of ``partisan_tpu/ops/rng.py``.  Two generators, both reproduced
bit for bit:

- :func:`rank32` — one murmur3 finalizer pass over a multiplicative-xor
  combine of integer coordinates (the round's hot-path ranking keys);
- threefry2x32 as jax 0.9.0 runs it with ``jax_threefry_partitionable``
  on (the default): ``key(seed)``, ``fold_in`` and 32-bit
  ``random_bits``.  Keys are int64 tensors ``[..., 2]`` holding the two
  uint32 key words.

``split2``, ``uniform`` and ``randint`` reproduce ``jax.random.split``
(the fold-like split of partitionable threefry: key j of a split is
``fold_in(key, j)``), scalar ``jax.random.uniform`` and scalar int32
``jax.random.randint`` per key.  ``choice_slots`` reproduces
``jax.random.gumbel`` + ``lax.top_k``.  The
gumbel transform ``-log(-log(u))`` of ``u = mantissa(bits >> 9)`` is
strictly increasing over all 2**23 mantissas in float32 (checked against
the reference in tests/test_torch_ops.py), so ranking by the integer
mantissa orders exactly as the float scores do, on any device.
"""

from __future__ import annotations

import torch

from partisan_tpu_torch.faults import MASK32, _mix32, mul32, u32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def rank32(seed: int, rnd: torch.Tensor, tag: int, a, b=0, c=0
           ) -> torch.Tensor:
    """Deterministic uint32 ranking keys (int64-held) from integer
    coordinates (node, slot, element), the round and a call-site tag."""
    site = (seed * 0x27D4EB2F + tag * 0x165667B1) & MASK32
    rest = (_term(b, 0x85EBCA77) ^ _term(c, 0xC2B2AE3D)
            ^ ((mul32(u32(rnd), 0x27D4EB2F) + site) & MASK32))
    return _mix32(_term(a, 0x9E3779B1) ^ rest)


def _term(v, c: int):
    """``uint32(v) * c`` — in Python for a Python int coordinate (no
    device tensor is made for a constant), else on the tensor."""
    if isinstance(v, int):
        return ((v & MASK32) * c) & MASK32
    return mul32(u32(v), c)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on int64-held uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK32
    y0 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + y0) & MASK32
            y0 = x0 ^ _rotl(y0, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        y0 = (y0 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, y0


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for a non-negative Python int seed."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch of keys ``[..., 2]``;
    ``data`` (int tensor or Python int) broadcasts against the batch."""
    d = u32(data, keys.device)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def round_key(seed: int, rnd: torch.Tensor) -> torch.Tensor:
    return fold_in(key(seed, rnd.device), rnd)


def node_keys(seed: int, rnd: torch.Tensor, node_ids: torch.Tensor
              ) -> torch.Tensor:
    """One key per node for this round: int64[n, 2]."""
    return fold_in(round_key(seed, rnd)[None, :], node_ids)


def subkey(keys: torch.Tensor, tag: int) -> torch.Tensor:
    """An independent stream per key for a named purpose."""
    return fold_in(keys, tag)


def random_bits(keys: torch.Tensor, v: int) -> torch.Tensor:
    """32-bit ``random_bits`` of shape ``(v,)`` per key: int64[..., v]."""
    lo = torch.arange(v, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def split2(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.split(key)`` per key: int64[..., 2, 2] (the two
    subkeys on the second-to-last axis)."""
    j = torch.arange(2, dtype=torch.int64, device=keys.device)
    return fold_in(keys[..., None, :], j)


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """Scalar float32 ``jax.random.uniform`` per key: the 23 high bits
    as a mantissa in [1, 2), minus 1 — exactly ``mant * 2**-23``."""
    return (random_bits(keys, 1)[..., 0] >> 9).to(torch.float32) \
        * (2.0 ** -23)


def randint(keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Scalar int32 ``jax.random.randint(key, (), lo, hi)`` per key."""
    return randint_bits(random_bits(split2(keys), 1)[..., 0], lo, hi)


def randint_bits(b: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``randint`` from its two draws ``b[..., 0:2]`` (the 32-bit bits of
    the split key's two halves), combined as ``(hi_bits % span * mult +
    lo_bits % span) % span`` in uint32 arithmetic, with ``mult = (2**16
    % span)**2 % span`` (the square wrapping at 2**32 as jax's does)."""
    span = hi - lo if hi > lo else 1
    mult = (((2 ** 16 % span) ** 2) & MASK32) % span
    off = (((b[..., 0] % span) * mult) & MASK32) + b[..., 1] % span
    return ((off & MASK32) % span + lo).to(torch.int32)


def choice_slots(keys: torch.Tensor, valid: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """Per key, ``k`` distinct slot indices of ``valid [N, v]`` in gumbel
    top-k order: int32[N, k], -1 where fewer than k are valid."""
    mant = random_bits(keys, valid.shape[-1]) >> 9
    score = torch.where(valid, mant + 1, 0)
    top = topk(score, k)[1]
    return torch.where(valid.gather(-1, top), top.to(torch.int32), -1)


def topk(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis: descending, lowest index first on
    ties (a stable descending sort, cut to k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
