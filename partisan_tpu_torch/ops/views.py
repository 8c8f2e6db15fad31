"""Fixed-width partial views (HyParView active/passive, SCAMP
partial/in views), batched.

Port of ``partisan_tpu/ops/views.py``.  A view is ``int32[K]`` of node
ids with -1 marking empty slots.  The reference writes each op for one
node and vmaps it; here every op takes a leading batch (node) axis.
Random inputs are per-node threefry keys ``int64[N, 2]`` (``add``,
``add_cap``, ``sample``, ``pick_one``), or, where a caller draws them
ahead, the draws themselves: ``add``'s slot (``ops/rng.randint``) and
``sample``'s gumbel mantissas (``ops/rng.random_bits >> 9``).
``admit`` and ``bucket_merge`` take uint32 ranking keys
(``ops/rng.rank32``).
"""

from __future__ import annotations

import torch

from partisan_tpu_torch.faults import _mix32
from partisan_tpu_torch.ops import rng
from partisan_tpu_torch.ops.rng import topk

EMPTY = -1


def empty(k: int, device=None) -> torch.Tensor:
    return torch.full((k,), EMPTY, dtype=torch.int32, device=device)


def empty_batch(n: int, k: int, device=None) -> torch.Tensor:
    return torch.full((n, k), EMPTY, dtype=torch.int32, device=device)


def contains(view: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """bool[N, C]: ids[N, C] present in view[N, K] (negative ids never)."""
    return ((view[:, None, :] == ids[:, :, None])
            & (ids >= 0)[:, :, None]).any(dim=2)


def size(view: torch.Tensor) -> torch.Tensor:
    """int32[N]: occupied slots per view."""
    return (view >= 0).sum(dim=-1, dtype=torch.int32)


def is_full(view: torch.Tensor) -> torch.Tensor:
    return (view >= 0).all(dim=-1)


def _put(view, nid, already, slot, use_slot_evict):
    """Write ``nid`` at ``slot`` unless ``already``; the displaced id
    where ``use_slot_evict``, else -1."""
    s = slot.to(torch.int64)[:, None]
    evicted = torch.where(use_slot_evict, view.gather(1, s)[:, 0], EMPTY)
    new = view.scatter(1, s, nid.to(view.dtype)[:, None])
    return (torch.where(already[:, None], view, new),
            torch.where(already, EMPTY, evicted))


def add_at(view: torch.Tensor, nid: torch.Tensor, rand_slot: torch.Tensor):
    """``add`` with its random slot already drawn (``rand_slot`` int32[N],
    ``rng.randint(key, 0, K)``): insert ``nid[N]`` at the first empty
    slot, or at ``rand_slot`` evicting its member when full.  A present
    or negative id is a no-op.  Returns (view', evicted int32[N])."""
    already = contains(view, nid[:, None])[:, 0] | (nid < 0)
    hole = view == EMPTY
    has_empty = hole.any(dim=1)
    slot = torch.where(has_empty, hole.to(torch.int8).argmax(dim=1),
                       rand_slot.to(torch.int64))
    return _put(view, nid, already, slot, ~has_empty)


def add(view: torch.Tensor, nid: torch.Tensor, keys: torch.Tensor):
    """Insert ``nid[N]``; if full, evict a RANDOM member
    (``jax.random.randint(key, (), 0, K)``).  Returns (view', evicted)."""
    return add_at(view, nid, rng.randint(keys, 0, view.shape[1]))


def add_cap(view: torch.Tensor, nid: torch.Tensor, keys: torch.Tensor,
            cap):
    """``add`` under a soft capacity ``cap`` (int or int[N]): the view
    counts as full once ``size >= cap``; at capacity a random member
    (``pick_one``) is evicted; ``cap <= 0`` rejects the add.  Returns
    (view', evicted)."""
    cap = torch.as_tensor(cap, device=view.device)
    already = contains(view, nid[:, None])[:, 0] | (nid < 0) | (cap <= 0)
    at_cap = size(view) >= cap
    hole = view == EMPTY
    has_empty = hole.any(dim=1)
    evictee = pick_one(view, keys)
    evict_slot = (view == evictee[:, None]).to(torch.int8).argmax(dim=1)
    use_evict = at_cap | ~has_empty
    slot = torch.where(use_evict, evict_slot,
                       hole.to(torch.int8).argmax(dim=1))
    return _put(view, nid, already, slot, use_evict)


def remove(view: torch.Tensor, nid: torch.Tensor) -> torch.Tensor:
    """Clear ``nid[N]`` from each row."""
    nid = nid[:, None]
    return torch.where((view == nid) & (nid >= 0), EMPTY, view)


def keep_only(view: torch.Tensor, keep_mask_of_id: torch.Tensor
              ) -> torch.Tensor:
    """Clear slots whose id fails the bool[n_global] lookup."""
    ids = view.clamp(min=0).to(torch.int64)
    return torch.where((view >= 0) & keep_mask_of_id[ids], view, EMPTY)


def sample_mant(view: torch.Tensor, mant: torch.Tensor, k: int,
                exclude: torch.Tensor | None = None) -> torch.Tensor:
    """``sample`` with its gumbel draws already made: ``mant`` int64
    [N, K] holds ``random_bits(key, K) >> 9``, which ranks exactly as
    the float gumbel scores do (ops/rng.py)."""
    valid = view >= 0
    if exclude is not None:
        valid = valid & ~(view[:, :, None] == exclude[:, None, :]).any(dim=2)
    score = torch.where(valid, mant + 1, 0)
    if k == 1:   # top-1: the first maximum, as lax.top_k orders ties
        top = score.argmax(dim=1, keepdim=True)
    else:
        top = topk(score, k)[1]
    return torch.where(valid.gather(1, top), view.gather(1, top), EMPTY)


def sample(view: torch.Tensor, keys: torch.Tensor, k: int,
           exclude: torch.Tensor | None = None) -> torch.Tensor:
    """int32[N, k]: k distinct random members per row (-1 padded),
    optionally excluding ids ``exclude[N, E]``."""
    return sample_mant(view, rng.random_bits(keys, view.shape[1]) >> 9, k,
                       exclude)


def pick_one(view: torch.Tensor, keys: torch.Tensor,
             exclude: torch.Tensor | None = None) -> torch.Tensor:
    """int32[N]: one random member per row (or -1)."""
    return sample(view, keys, 1, exclude)[:, 0]


def admit(view: torch.Tensor, cands: torch.Tensor, prio: torch.Tensor,
          scores: torch.Tensor, cap: torch.Tensor):
    """Batched multi-candidate admission with random eviction.

    view int32[N, A]; cands int32[N, C] (-1 none, duplicates allowed);
    prio int32[N, C]; scores int64[N, A+C] uniform uint32 keys; cap
    int32[N].  Returns (view' int32[N, A], admitted bool[N, C], evicted
    int32[N, A])."""
    a_width = view.shape[1]
    c_width = cands.shape[1]
    cap = cap.to(torch.int32)
    valid_c = (cands >= 0) & (cap > 0)[:, None] & ~contains(view, cands)
    # dedupe among candidates: keep the max-prio copy (first on ties)
    idx = torch.arange(c_width, device=view.device)
    eff = torch.where(valid_c, prio, -1)
    same = (cands[:, None, :] == cands[:, :, None]) & valid_c[:, None, :] \
        & valid_c[:, :, None]                                # [N, i, j]
    beats = (eff[:, None, :] > eff[:, :, None]) | (
        (eff[:, None, :] == eff[:, :, None])
        & (idx[None, None, :] < idx[None, :, None]))
    valid_c = valid_c & ~(same & beats).any(dim=2)

    # members below candidates, priority above the 27-bit random tie-break
    g = scores >> 5
    rank_m = torch.where(view >= 0, g[:, :a_width], 0)
    rank_c = torch.where(
        valid_c, g[:, a_width:] + (1 << 30) + prio.to(torch.int64) * (1 << 27),
        0) & 0xFFFFFFFF
    score = torch.cat([torch.where(view >= 0, rank_m + 1, 0), rank_c], dim=1)
    n_keep = torch.where(valid_c.any(dim=1),
                         torch.clamp(cap, max=a_width), a_width)
    vals, top = topk(score, a_width)
    keep = (vals > 0) & (torch.arange(a_width, device=view.device)[None, :]
                         < n_keep[:, None])
    ids_all = torch.cat([view, cands], dim=1)
    new_view = torch.where(keep, ids_all.gather(1, top), EMPTY)
    admitted = valid_c & contains(new_view, cands)
    survived = contains(new_view, view)
    evicted = torch.where((view >= 0) & ~survived, view, EMPTY)
    return new_view, admitted, evicted


def bucket_slot(ids: torch.Tensor, width: int) -> torch.Tensor:
    """Stable bucket index ``mix32(id) % width`` (see bucket_merge)."""
    return (_mix32(ids) % width).to(torch.int32)


def bucket_merge(view: torch.Tensor, cands: torch.Tensor,
                 ranks: torch.Tensor, self_id: torch.Tensor,
                 exclude: torch.Tensor | None = None) -> torch.Tensor:
    """Merge candidates into id-keyed bucket cache views, batched.

    view int32[N, P] (slot p holds -1 or an id with bucket p); cands
    int32[N, C]; ranks int64[N, C] uint32 tie-break keys; self_id
    int32[N]; exclude int32[N, E] ids barred from entry.  Per slot, the
    highest-ranked hitting candidate wins (first index on equal ranks)."""
    n, p_width = view.shape
    c_width = cands.shape[1]
    dev = view.device
    ok = (cands >= 0) & (cands != self_id[:, None])
    if exclude is not None:
        ok = ok & ~(cands[:, :, None] == exclude[:, None, :]).any(dim=2)
    slot = bucket_slot(cands, p_width)
    rank = torch.where(ok, ranks | 1, 0)
    tgt = torch.where(ok, slot, p_width).to(torch.int64)
    best = torch.zeros((n, p_width + 1), dtype=torch.int64, device=dev) \
        .scatter_reduce(1, tgt, rank, "amax", include_self=True)[:, :p_width]
    slot_c = torch.clamp(slot, max=p_width - 1).to(torch.int64)
    is_best = ok & (rank == best.gather(1, slot_c))
    idx = torch.arange(c_width, dtype=torch.int64, device=dev) \
        .expand(n, c_width)
    win = torch.full((n, p_width + 1), c_width, dtype=torch.int64,
                     device=dev).scatter_reduce(
        1, torch.where(is_best, slot, p_width).to(torch.int64), idx, "amin",
        include_self=True)[:, :p_width]
    has = best > 0
    got = cands.gather(1, torch.clamp(win, max=c_width - 1))
    return torch.where(has, got, view)
