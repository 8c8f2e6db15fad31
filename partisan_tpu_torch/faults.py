"""Fault injection: crash-stop masks, partitions, iid link drops.

Port of ``partisan_tpu/faults.py``.  Partitions come in two modes: a
dense ``bool[n, n]`` matrix (True = edge severed, any edge set) and
groups (``int32[n]`` labels, edges cut between differing labels).  Every
drop decision depends only on (seed, round, src, dst, salt) through the
murmur3 finalizer, so a fault schedule replays exactly and matches the
reference bit for bit.

uint32 arithmetic: torch lacks uint32 shifts, sorts and scatter-max on
the CPU, so hashes ride int64 tensors holding values in ``[0, 2**32)``
on both devices — one code path.  A product of two 32-bit values can
leave int64's signed range, so multiplication by a 32-bit constant goes
through :func:`mul32`, which splits the constant into 16-bit halves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from partisan_tpu_torch.types import W_DST, W_KIND, W_SRC

MASK32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """An int32/int64 tensor (or Python int) as int64 uint32 bits."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(int(x), dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) and a constant c: each
    partial product stays below 2**49."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over int64-held uint32 values."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


class FaultState(NamedTuple):
    alive: torch.Tensor      # bool[n] — False = crash-stopped
    link_drop: torch.Tensor  # float32 scalar — iid per-edge drop probability
    partition: torch.Tensor  # dense: bool[n, n], True = edge severed;
    #                          groups: int32[n] labels, edges between
    #                          differing labels cut


def none(n: int, partition_mode: str = "dense", device=None) -> FaultState:
    if partition_mode == "dense":
        part = torch.zeros((n, n), dtype=torch.bool, device=device)
    elif partition_mode == "groups":
        part = torch.zeros(n, dtype=torch.int32, device=device)
    else:
        raise ValueError(f"partition_mode {partition_mode!r} not in "
                         f"('dense', 'groups')")
    return FaultState(
        alive=torch.ones(n, dtype=torch.bool, device=device),
        link_drop=torch.tensor(0.0, dtype=torch.float32, device=device),
        partition=part)


def edge_hash(seed: int, rnd: torch.Tensor, salt: int, src, dst
              ) -> torch.Tensor:
    """Deterministic uint32 hash per (edge, round, call site)."""
    site = (seed * 0x27D4EB2F + salt) & MASK32
    h = _mix32(u32(src) ^ 0x9E3779B1)
    h = _mix32(h ^ u32(dst))
    return _mix32(h ^ (u32(rnd) ^ site))


def hash_bernoulli(h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """True with probability p (quantized to 2^-24): the top 24 hash bits
    convert to float32 exactly and compare against ``p * 2**24``."""
    return (h >> 8).to(torch.float32) < \
        p.to(torch.float32) * float(2 ** 24)


_GROUP_BITS_MASK = 0x1FFFFFFF


def check_group_labels(partition) -> None:
    """Host-side check that group labels fit the 29 packed bits."""
    p = np.asarray(partition.cpu() if isinstance(partition, torch.Tensor)
                   else partition)
    if p.size and (int(p.min()) < 0 or int(p.max()) > _GROUP_BITS_MASK):
        raise ValueError(
            f"partition group labels must fit 29 unsigned bits; got range "
            f"[{int(p.min())}, {int(p.max())}]")


def pack_wire_info(faults: FaultState, backed) -> torch.Tensor:
    """int32[n]: per-destination wire facts — bit0 alive, bit1 inbox
    backpressure, bits 2.. partition group."""
    alive = faults.alive.to(torch.int32)
    b = torch.zeros_like(alive) if backed is None else backed.to(torch.int32)
    return alive | (b << 1) | ((faults.partition & _GROUP_BITS_MASK) << 2)


def edge_cut(faults: FaultState, src: torch.Tensor, dst: torch.Tensor,
             seed: int, rnd: torch.Tensor, salt: int) -> torch.Tensor:
    """bool mask, True where the (src, dst) edge is cut this round
    (dst < 0 = unused slot, reported uncut)."""
    n = faults.alive.shape[0]
    ok_dst = dst >= 0
    d = torch.where(ok_dst, dst, 0)
    s = torch.where(src >= 0, src, 0)
    # gathers clamp out-of-range ids (the reference's gather semantics);
    # the hash below reads the unclamped ids
    sc = s.clamp(max=n - 1).to(torch.int64)
    dc = d.clamp(max=n - 1).to(torch.int64)
    if faults.partition.dim() == 2:
        cut = faults.partition[sc, dc] | ~faults.alive[dc] \
            | ~faults.alive[sc]
    else:
        packed = pack_wire_info(faults, None)
        ps, pd = packed[sc], packed[dc]
        cut = ((ps >> 2) != (pd >> 2)) | ((ps & 1) == 0) | ((pd & 1) == 0)
    drop = hash_bernoulli(edge_hash(seed, rnd, salt, s, d), faults.link_drop)
    return ok_dst & (cut | drop)


def filter_edges(faults: FaultState, src_gids: torch.Tensor,
                 dst: torch.Tensor, seed: int, rnd: torch.Tensor,
                 salt: int) -> torch.Tensor:
    """Null out (-1) gossip edges hit by faults. dst: int32[n, K]."""
    src = src_gids[:, None].expand(dst.shape)
    return torch.where(edge_cut(faults, src, dst, seed, rnd, salt), -1, dst)


def filter_msgs(faults: FaultState, emitted, seed: int, rnd: torch.Tensor,
                salt: int):
    """Crash + omission faults over a record stack (kind := NONE where
    the edge is cut)."""
    from partisan_tpu_torch.ops import plane as plane_ops

    kind = emitted[W_KIND]
    dst = torch.where(kind != 0, emitted[W_DST], -1)
    cut = edge_cut(faults, emitted[W_SRC], dst, seed, rnd, salt)
    return plane_ops.set_word(emitted, W_KIND, torch.where(cut, 0, kind))


def wire_cut_from_info(faults: FaultState, info_d: torch.Tensor,
                       valid: torch.Tensor, src_gid: torch.Tensor,
                       dst: torch.Tensor, alive_src: torch.Tensor,
                       group_src: torch.Tensor, seed: int,
                       rnd: torch.Tensor, salt: int) -> torch.Tensor:
    """``edge_cut`` evaluated against a packed destination-info gather
    (``info_d = pack_wire_info(...)[dst]``); the source facts are the
    emitting row's own."""
    alive_d = (info_d & 1) == 1
    group_d = info_d >> 2
    cut = (group_src[:, None] & _GROUP_BITS_MASK) != group_d
    cut = cut | ~alive_d | ~alive_src[:, None]
    d = torch.where(valid, dst, 0)
    drop = hash_bernoulli(edge_hash(seed, rnd, salt, src_gid[:, None], d),
                          faults.link_drop)
    return valid & (cut | drop)


# --- churn engine (the scenario suite's config 4) -----------------------

_CHURN_DEATH_TAG = 31
_CHURN_BIRTH_TAG = 32


def churn_step(faults: FaultState, seed: int, rnd: torch.Tensor, death_p,
               birth_p) -> FaultState:
    """One round of a birth/death process over the alive mask: each
    alive node crash-stops with probability ``death_p``, each dead node
    revives with probability ``birth_p``, decided by the counter hash of
    (seed, round, node)."""
    n = faults.alive.shape[0]
    dev = faults.alive.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def p(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    die = hash_bernoulli(edge_hash(seed, rnd, _CHURN_DEATH_TAG, ids, ids),
                         p(death_p))
    born = hash_bernoulli(edge_hash(seed, rnd, _CHURN_BIRTH_TAG, ids, ids),
                          p(birth_p))
    return faults._replace(alive=torch.where(faults.alive, ~die, born))


# --- scenario scripting (host-side, between steps) ----------------------

def _set_alive(faults: FaultState, node: int, value: bool) -> FaultState:
    alive = faults.alive.clone()
    alive[node] = value
    return faults._replace(alive=alive)


def crash(faults: FaultState, node: int) -> FaultState:
    return _set_alive(faults, node, False)


def recover(faults: FaultState, node: int) -> FaultState:
    return _set_alive(faults, node, True)


def crash_many(faults: FaultState, nodes) -> FaultState:
    idx = torch.as_tensor(np.asarray(nodes), dtype=torch.int64,
                          device=faults.alive.device)
    alive = faults.alive.clone()
    alive[idx] = False
    return faults._replace(alive=alive)


def set_link_drop(faults: FaultState, p: float) -> FaultState:
    return faults._replace(link_drop=torch.tensor(
        p, dtype=torch.float32, device=faults.alive.device))


def inject_partition(faults: FaultState, group_a, group_b) -> FaultState:
    """Sever all edges between two node groups.  Dense mode cuts exactly
    the a x b edges, both ways.  Groups mode expresses only full splits
    (the two groups must cover every node); it composes with an existing
    split as a refinement, then re-densifies the labels on the host."""
    p = faults.partition
    if p.dim() == 2:
        a = torch.as_tensor(np.asarray(group_a), dtype=torch.int64,
                            device=p.device)
        b = torch.as_tensor(np.asarray(group_b), dtype=torch.int64,
                            device=p.device)
        p = p.clone()
        p[a[:, None], b[None, :]] = True
        p[b[:, None], a[None, :]] = True
        return faults._replace(partition=p)
    sa = set(np.asarray(group_a).tolist())
    sb = set(np.asarray(group_b).tolist())
    if sa & sb or len(sa) + len(sb) != p.shape[0]:
        raise ValueError(
            "groups partition mode expresses only full splits: group_a "
            f"({len(sa)}) + group_b ({len(sb)}) must disjointly cover all "
            f"{p.shape[0]} nodes")
    side = np.zeros(p.shape[0], np.int64)
    side[np.asarray(sorted(sb), np.int64)] = 1
    refined = p.cpu().numpy().astype(np.int64) * 2 + side
    _, inv = np.unique(refined, return_inverse=True)
    check_group_labels(inv)
    return faults._replace(partition=torch.as_tensor(
        inv.astype(np.int32), device=p.device))


def resolve_partition(faults: FaultState) -> FaultState:
    return faults._replace(partition=torch.zeros_like(faults.partition))
