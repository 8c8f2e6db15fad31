"""Device-resident health plane: topology snapshots of the live overlay
(port of ``partisan_tpu/health.py``, the single-device plane).

Every ``Config.health`` rounds the round body computes one snapshot of
the graph the managers' neighbor rows describe and writes it into a ring
of ``Config.health_ring`` slots: the connected-component count of the
undirected union of live out-edges (pointer-jumping min-label
propagation), the isolated alive nodes, the out-degree histogram and
its min/max over alive nodes, the directed edges whose reverse is
absent, and the join/leave/up/down churn since the previous snapshot.
It also packs one int32 digest word — the one-scalar poll
``scenarios._converge`` reads.  ``Config.health=0`` keeps the state leaf
``()``.

The snapshot runs the reference's segment-local kernels: each shard
of a sharded cluster (``parallel/sharded.py``) touches only its own
``[n_local, K]`` neighbor rows, and the cross-shard state is label and
alive VECTORS (the FastSV halo) and scalar reductions, never a gathered
``[n, K]`` table.  On a ``LocalComm`` every collective is the identity
and the segment-local kernels run exactly the global kernels' ops.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Out-degree histogram bins: degree d lands in bin min(d, DEG_BINS-1).
DEG_BINS = 16

# Digest word layout (int32, bit 31 unused so the word stays positive).
DIGEST_ONE_COMPONENT = 1 << 0   # exactly one connected component
DIGEST_NO_ISOLATES = 1 << 1     # no alive node with zero live out-edges
DIGEST_MIN_DEGREE = 1 << 2      # min alive out-degree >= target
DIGEST_COVERAGE = 1 << 3        # model coverage complete (slot 0)
DIGEST_VALID = 1 << 4           # a snapshot has been recorded
_COMP_SHIFT, _COMP_MASK = 8, 0xFFFF   # clamped component count
_ISO_SHIFT, _ISO_MASK = 24, 0x7F      # clamped isolated-alive count

_BIG = 2 ** 30

# Above this many [n, K, K] elements the symmetry check runs slot-wise
# (O(n·K) memory per step instead of one O(n·K²) gather).
SYM_ONESHOT_ELEMS = 1 << 24


class HealthState(NamedTuple):
    """Ring of topology snapshots + the latest packed digest
    (``R = Config.health_ring``; ``rnd[slot] == -1`` marks an empty
    slot)."""

    rnd: torch.Tensor           # int32[R] — round the snapshot describes
    components: torch.Tensor    # int32[R]
    isolated: torch.Tensor      # int32[R]
    deg_hist: torch.Tensor      # int32[R, DEG_BINS]
    deg_min: torch.Tensor       # int32[R]
    deg_max: torch.Tensor       # int32[R]
    sym_violations: torch.Tensor  # int32[R]
    joins: torch.Tensor         # int32[R]
    leaves: torch.Tensor        # int32[R]
    ups: torch.Tensor           # int32[R]
    downs: torch.Tensor         # int32[R]
    digests: torch.Tensor       # int32[R]
    digest: torch.Tensor        # int32 scalar — the latest digest
    prev_alive: torch.Tensor    # bool[n] — alive mask at the last snapshot
    prev_conn: torch.Tensor     # bool[n] — alive & degree>0 at the last


def enabled(cfg) -> bool:
    return cfg.health > 0


def min_degree_target(cfg) -> int:
    """HyParView's active_min under the hyparview manager, else 1."""
    if cfg.peer_service_manager == "hyparview":
        return cfg.hyparview.active_min
    return 1


def init(cfg, device=None) -> HealthState:
    R = cfg.health_ring

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return HealthState(
        rnd=torch.full((R,), -1, dtype=torch.int32, device=device),
        components=z(R), isolated=z(R), deg_hist=z(R, DEG_BINS),
        deg_min=z(R), deg_max=z(R), sym_violations=z(R),
        joins=z(R), leaves=z(R), ups=z(R), downs=z(R), digests=z(R),
        digest=z(),
        prev_alive=torch.zeros(cfg.n_nodes, dtype=torch.bool,
                               device=device),
        prev_conn=torch.zeros(cfg.n_nodes, dtype=torch.bool,
                              device=device))


# ---------------------------------------------------------------------------
# Graph kernels
# ---------------------------------------------------------------------------

def live_edges(nbrs: torch.Tensor, alive: torch.Tensor,
               partition: torch.Tensor | None = None) -> torch.Tensor:
    """bool[n, K]: out-edge slots with a valid neighbor id, both ends
    alive and the edge not severed by a partition (groups int32[n] or
    dense bool[n, n]).  The stochastic link drop is not applied."""
    n = alive.shape[0]
    nc = nbrs.clamp(0, n - 1).to(torch.int64)
    live = (nbrs >= 0) & alive[:, None] & alive[nc]
    if partition is not None and partition.dim() > 0:
        if partition.dim() == 2:
            rows = torch.arange(n, device=nbrs.device)[:, None]
            live = live & ~partition[rows, nc]
        else:
            live = live & (partition[:, None] == partition[nc])
    return live


def component_count(nbrs: torch.Tensor, alive: torch.Tensor,
                    partition: torch.Tensor | None = None):
    """Connected components of the undirected union of live out-edges:
    ``(labels int32[n], count int32)``, ``labels[i]`` the minimum alive
    id in i's component (own id for dead nodes).

    FastSV pointer jumping for ``ceil(log2 n) + 4`` iterations: shortcut
    ``f[f]``, hook each endpoint onto the other's grandparent and each
    endpoint's parent onto the other's grandparent.  The three min
    scatters of an iteration are one ``scatter_reduce("amin")`` onto a
    drop row at index n — min is order-free, so the card gives the same
    labels on every run."""
    n = alive.shape[0]
    dev = alive.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    if nbrs.shape[1] == 0 or n == 1:
        return ids.to(torch.int32), alive.sum(dtype=torch.int32)
    nc = nbrs.clamp(0, n - 1).to(torch.int64)
    live = live_edges(nbrs, alive, partition)
    tgt_v = torch.where(live, nc, n).reshape(-1)
    drop = torch.full((1,), n, dtype=torch.int64, device=dev)
    f = ids
    for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 4):
        g = f[f]                                         # grandparent
        gv = torch.where(live, g[nc], n)                 # nbr grandparents
        gb = g[:, None].expand(live.shape).reshape(-1)
        # shortcut + aggressive hooking of this row
        m = torch.minimum(torch.minimum(f, g), gv.min(dim=1).values)
        # hooking from both edge directions and the tree-onto-tree step
        fu = torch.where(live, f[:, None], n).reshape(-1)
        fv = torch.where(live, f[nc], n).reshape(-1)
        f = torch.cat([m, drop]).scatter_reduce(
            0, torch.cat([tgt_v, fu, fv]),
            torch.cat([gb, gv.reshape(-1), gb]), "amin",
            include_self=True)[:n]
    count = ((f == ids) & alive).sum(dtype=torch.int32)
    return f.to(torch.int32), count


def out_degrees(nbrs: torch.Tensor, alive: torch.Tensor,
                partition: torch.Tensor | None = None) -> torch.Tensor:
    """int32[n]: live out-degree per node (0 for dead nodes)."""
    return live_edges(nbrs, alive, partition).sum(dim=1, dtype=torch.int32)


def _sharded(comm, n: int) -> bool:
    return comm.n_local != n


def live_edges_local(nbrs_local: torch.Tensor, alive_local: torch.Tensor,
                     alive_global: torch.Tensor, comm,
                     partition: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """bool[n_local, K]: :func:`live_edges` for one shard's rows; remote
    endpoints are read from the replicated ``alive_global`` vector."""
    n = alive_global.shape[0]
    nc = nbrs_local.clamp(0, n - 1).to(torch.int64)
    live = (nbrs_local >= 0) & alive_local[:, None] & alive_global[nc]
    if partition is not None and partition.dim() > 0:
        if partition.dim() == 2:
            rows = comm.local_ids().to(torch.int64)[:, None] \
                if _sharded(comm, n) \
                else torch.arange(n, device=nbrs_local.device)[:, None]
            live = live & ~partition[rows, nc]
        else:
            live = live & (comm.local(partition)[:, None] == partition[nc])
    return live


def component_count_sharded(nbrs_local: torch.Tensor,
                            alive_global: torch.Tensor, comm,
                            partition: torch.Tensor | None = None):
    """Segment-local FastSV with a label halo: :func:`component_count`
    for one shard's rows, equal to it by construction.  Each shard keeps
    labels for its own rows and, per iteration, exchanges two label
    vectors: the halo gather (``comm.gather_vec`` of its labels, so its
    edges read remote neighbors' labels) and the halo reduce (its hook
    proposals for every node, met across shards by ``comm.allmin`` and
    sliced back).  min is order-free, so the concatenated labels equal
    the global kernel's after every iteration.  Returns ``(labels
    int32[n_local], count int32)``, the count allsum-reduced."""
    n = alive_global.shape[0]
    dev = alive_global.device
    if not _sharded(comm, n):
        return component_count(nbrs_local, alive_global, partition)
    gids = comm.local_ids().to(torch.int64)
    alive_l = comm.local(alive_global)
    if nbrs_local.shape[1] == 0 or n == 1:
        return gids.to(torch.int32), comm.allsum(
            alive_l.sum(dtype=torch.int32))
    nc = nbrs_local.clamp(0, n - 1).to(torch.int64)
    live = live_edges_local(nbrs_local, alive_l, alive_global, comm,
                            partition)
    tgt_v = torch.where(live, nc, n).reshape(-1)
    fill = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    f_l = gids
    for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 4):
        f_g = comm.gather_vec(f_l)                       # the halo
        g_g = f_g[f_g]                                   # grandparents
        g_l = comm.local(g_g)
        gv = torch.where(live, g_g[nc], n)               # nbr grandparents
        gb = g_l[:, None].expand(live.shape).reshape(-1)
        m = torch.minimum(torch.minimum(f_l, g_l), gv.min(dim=1).values)
        fu = torch.where(live, f_l[:, None], n).reshape(-1)
        fv = torch.where(live, f_g[nc], n).reshape(-1)
        # hook proposals for any node, this shard's and remote ones
        prop = fill.scatter_reduce(
            0, torch.cat([tgt_v, fu, fv]),
            torch.cat([gb, gv.reshape(-1), gb]), "amin",
            include_self=True)[:n]
        f_l = torch.minimum(m, comm.local(comm.allmin(prop)))
    count = comm.allsum(((f_l == gids) & alive_l).sum(dtype=torch.int32))
    return f_l.to(torch.int32), count


def symmetry_violations_sharded(nbrs_local: torch.Tensor,
                                alive_global: torch.Tensor, comm,
                                partition: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """:func:`symmetry_violations` over one shard's rows: the back-edge
    check reads one neighbor-table column at a time, exchanged as a
    global ``[n]`` vector, against this shard's ``[n_local, K]`` edges;
    allsum-reduced."""
    n = alive_global.shape[0]
    if not _sharded(comm, n):
        return symmetry_violations(nbrs_local, alive_global, partition)
    K = nbrs_local.shape[1]
    if K == 0:
        return comm.allsum(torch.zeros((), dtype=torch.int32,
                                       device=nbrs_local.device))
    gids = comm.local_ids()
    alive_l = comm.local(alive_global)
    nc = nbrs_local.clamp(0, n - 1).to(torch.int64)
    live = live_edges_local(nbrs_local, alive_l, alive_global, comm,
                            partition)
    me = gids[:, None]
    has_back = torch.zeros_like(live)
    for s in range(K):
        col = comm.gather_vec(nbrs_local[:, s].contiguous())  # [n]
        has_back = has_back | (col[nc] == me)
    return comm.allsum((live & ~has_back).sum(dtype=torch.int32))


def symmetry_violations(nbrs: torch.Tensor, alive: torch.Tensor,
                        partition: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """int32: live directed edges i->j with no j->i entry in j's view.
    One ``[n, K, K]`` gather up to ``SYM_ONESHOT_ELEMS`` elements, else
    one ``[n, K]`` gather per slot."""
    n, K = nbrs.shape
    if K == 0:
        return torch.zeros((), dtype=torch.int32, device=nbrs.device)
    nc = nbrs.clamp(0, n - 1).to(torch.int64)
    live = live_edges(nbrs, alive, partition)
    ids = torch.arange(n, dtype=nbrs.dtype, device=nbrs.device)
    if n * K * K <= SYM_ONESHOT_ELEMS:
        has_back = (nbrs[nc] == ids[:, None, None]).any(dim=-1)
        return (live & ~has_back).sum(dtype=torch.int32)
    miss = torch.zeros_like(live)
    for s in range(K):
        miss[:, s] = ~(nbrs[nc[:, s]] == ids[:, None]).any(dim=1)
    return (live & miss).sum(dtype=torch.int32)


def degree_histogram(deg: torch.Tensor, alive: torch.Tensor
                     ) -> torch.Tensor:
    """int32[DEG_BINS]: alive nodes' out-degrees, the last bin absorbing
    degrees >= DEG_BINS-1."""
    b = deg.clamp(0, DEG_BINS - 1).to(torch.int64)
    b = torch.where(alive, b, DEG_BINS)
    return torch.zeros(DEG_BINS + 1, dtype=torch.int32,
                       device=deg.device).scatter_add(
        0, b, torch.ones_like(b, dtype=torch.int32))[:DEG_BINS]


def pack_digest(components, isolated, deg_min, n_alive,
                min_deg_target: int, cov_ok) -> torch.Tensor:
    """The packed one-scalar health word (layout at the top)."""
    one = (components == 1).to(torch.int32)
    noiso = (isolated == 0).to(torch.int32)
    degok = ((deg_min >= min_deg_target) & (n_alive > 0)).to(torch.int32)
    cov = torch.as_tensor(cov_ok, device=components.device).to(torch.int32)
    return (one * DIGEST_ONE_COMPONENT | noiso * DIGEST_NO_ISOLATES
            | degok * DIGEST_MIN_DEGREE | cov * DIGEST_COVERAGE
            | DIGEST_VALID
            | components.clamp(0, _COMP_MASK) << _COMP_SHIFT
            | isolated.clamp(0, _ISO_MASK) << _ISO_SHIFT).to(torch.int32)


def decode_digest(word: int) -> dict:
    """Host-side view of a packed digest word."""
    word = int(word)
    return {
        "valid": bool(word & DIGEST_VALID),
        "one_component": bool(word & DIGEST_ONE_COMPONENT),
        "no_isolates": bool(word & DIGEST_NO_ISOLATES),
        "min_degree_ok": bool(word & DIGEST_MIN_DEGREE),
        "coverage_complete": bool(word & DIGEST_COVERAGE),
        "components": (word >> _COMP_SHIFT) & _COMP_MASK,
        "isolated": (word >> _ISO_SHIFT) & _ISO_MASK,
    }


def healthy(word: int) -> bool:
    """All four predicate bits set on a valid digest."""
    bits = (DIGEST_VALID | DIGEST_ONE_COMPONENT | DIGEST_NO_ISOLATES
            | DIGEST_MIN_DEGREE | DIGEST_COVERAGE)
    return (int(word) & bits) == bits


OVERLAY_BITS = (DIGEST_ONE_COMPONENT | DIGEST_NO_ISOLATES
                | DIGEST_MIN_DEGREE)


def overlay_ok(word: int) -> bool:
    """Valid digest with the one-component, no-isolates and min-degree
    bits all set (coverage aside)."""
    bits = DIGEST_VALID | OVERLAY_BITS
    return (int(word) & bits) == bits


def digest_converged(word: int) -> bool:
    """A recorded snapshot whose coverage bit is set."""
    bits = DIGEST_VALID | DIGEST_COVERAGE
    return (int(word) & bits) == bits


def digest_components(word: int) -> int:
    """Component count carried in the digest (clamped at 0xFFFF)."""
    return (int(word) >> _COMP_SHIFT) & _COMP_MASK


def digest(state) -> int | list:
    """One device->host read: the latest digest word of a state (0 =
    plane off or no snapshot yet); a fleet state (leading member axis)
    gives the per-member list of words."""
    hs = getattr(state, "health", ())
    if isinstance(hs, tuple) and not hasattr(hs, "_fields"):
        return 0
    return hs.digest.tolist()


# ---------------------------------------------------------------------------
# The snapshot writer
# ---------------------------------------------------------------------------

def record_snapshot(cfg, comm, hs: HealthState, *, rnd: torch.Tensor,
                    nbrs_local: torch.Tensor, alive_global: torch.Tensor,
                    cov_ok, partition: torch.Tensor | None = None
                    ) -> HealthState:
    """Compute one topology snapshot and write it into the ring.
    ``nbrs_local`` is this shard's neighbor rows (global ids); every
    graph kernel runs segment-locally over them and the ring values are
    reduced, so every shard writes the same ring.  ``alive_global``
    arrives masked by the active prefix under ``Config.width_operand``;
    ``cov_ok`` is the cross-shard slot-0 coverage-complete predicate
    (True without a coverage notion).  The first snapshot only sets the
    churn baseline (zero churn)."""
    R = cfg.health_ring
    alive = alive_global
    alive_l = comm.local(alive)
    _, comps = component_count_sharded(nbrs_local, alive, comm, partition)
    deg = live_edges_local(nbrs_local, alive_l, alive, comm,
                           partition).sum(dim=1, dtype=torch.int32)
    n_alive = comm.allsum(alive_l.sum(dtype=torch.int32))
    iso = comm.allsum((alive_l & (deg == 0)).sum(dtype=torch.int32))
    hist = comm.allsum(degree_histogram(deg, alive_l))
    dmin = torch.where(
        n_alive > 0, comm.allmin(torch.where(alive_l, deg, _BIG).min()),
        0).to(torch.int32)
    dmax = comm.allmax(torch.where(alive_l, deg, 0).max()).to(torch.int32)
    sym = symmetry_violations_sharded(nbrs_local, alive, comm, partition)

    first = (hs.digest & DIGEST_VALID) == 0
    # segment-local connectivity, gathered back to the replicated vector
    # the churn windows diff against
    conn = comm.gather_vec(alive_l & (deg > 0))

    def window(prev, now):
        return torch.where(first, 0, (prev & now).sum(dtype=torch.int32)) \
            .to(torch.int32)

    word = pack_digest(comps, iso, dmin, n_alive, min_degree_target(cfg),
                       cov_ok)
    # consecutive snapshots take consecutive slots at any cadence
    slot = (((rnd + 1) // cfg.health - 1) % R).to(torch.int64)

    def put(ring, value):
        out = ring.clone()
        out[slot] = value
        return out

    return HealthState(
        rnd=put(hs.rnd, rnd), components=put(hs.components, comps),
        isolated=put(hs.isolated, iso), deg_hist=put(hs.deg_hist, hist),
        deg_min=put(hs.deg_min, dmin), deg_max=put(hs.deg_max, dmax),
        sym_violations=put(hs.sym_violations, sym),
        joins=put(hs.joins, window(~hs.prev_conn, conn)),
        leaves=put(hs.leaves, window(hs.prev_conn, ~conn)),
        ups=put(hs.ups, window(~hs.prev_alive, alive)),
        downs=put(hs.downs, window(hs.prev_alive, ~alive)),
        digests=put(hs.digests, word), digest=word,
        prev_alive=alive, prev_conn=conn)


# ---------------------------------------------------------------------------
# Host-side readers
# ---------------------------------------------------------------------------

_SERIES = ("components", "isolated", "deg_hist", "deg_min", "deg_max",
           "sym_violations", "joins", "leaves", "ups", "downs", "digests")


def ring_order(rnd) -> np.ndarray:
    """The slot order of a ring's round labels (-1 = never written) that
    yields rounds ascending (own copy of ``partisan_tpu.metrics``')."""
    rnd = np.asarray(rnd)
    keep = np.flatnonzero(rnd >= 0)
    return keep[np.argsort(rnd[keep], kind="stable")]


def snapshot(hs: HealthState) -> dict:
    """Decode the ring into per-snapshot series ordered by round."""
    host = {name: getattr(hs, name).cpu().numpy()
            for name in ("rnd",) + _SERIES}
    idx = ring_order(host["rnd"])
    out: dict = {"rounds": host["rnd"][idx]}
    for name in _SERIES:
        out[name] = host[name][idx]
    return out


def transitions(snap: dict, *, churn_threshold: int = 1,
                falling: bool = False) -> list[dict]:
    """The ring's discrete overlay transitions, round-keyed:
    ``partition_detected`` (components rise above 1 after some snapshot
    showed one), ``overlay_healed`` (back to 1), ``churn`` (windowed
    join/leave/up/down total at or above ``churn_threshold``, edge
    triggered) and, with ``falling``, ``churn_settled``."""
    comps = np.asarray(snap["components"])
    rounds = np.asarray(snap["rounds"])
    churn_total = (np.asarray(snap["joins"]) + np.asarray(snap["leaves"])
                   + np.asarray(snap["ups"]) + np.asarray(snap["downs"]))
    out: list[dict] = []
    was_one = split = churn_hot = False
    for i, rnd in enumerate(rounds):
        c = int(comps[i])
        if split and c == 1:
            out.append({"kind": "overlay_healed", "round": int(rnd),
                        "components": c})
            split = False
        if was_one and not split and c > 1:
            out.append({"kind": "partition_detected", "round": int(rnd),
                        "components": c,
                        "isolated": int(snap["isolated"][i])})
            split = True
        was_one = was_one or c == 1
        hot = int(churn_total[i]) >= churn_threshold
        if hot and not churn_hot:
            out.append({"kind": "churn", "round": int(rnd),
                        "joins": int(snap["joins"][i]),
                        "leaves": int(snap["leaves"][i]),
                        "ups": int(snap["ups"][i]),
                        "downs": int(snap["downs"][i])})
        elif falling and churn_hot and not hot:
            out.append({"kind": "churn_settled", "round": int(rnd),
                        "quiet": int(churn_total[i])})
        churn_hot = hot
    return out


def rows(snap: dict) -> list[dict]:
    """One self-describing dict per snapshot (JSON lines)."""
    return [{
        "round": int(r),
        "components": int(snap["components"][i]),
        "isolated": int(snap["isolated"][i]),
        "degree": {"min": int(snap["deg_min"][i]),
                   "max": int(snap["deg_max"][i]),
                   "hist": snap["deg_hist"][i].astype(int).tolist()},
        "symmetry_violations": int(snap["sym_violations"][i]),
        "churn": {"joins": int(snap["joins"][i]),
                  "leaves": int(snap["leaves"][i]),
                  "ups": int(snap["ups"][i]),
                  "downs": int(snap["downs"][i])},
        "digest": decode_digest(snap["digests"][i]),
    } for i, r in enumerate(snap["rounds"])]
