"""The round-cost census: what one round dispatches, priced per
``round.*`` phase (the port of ``partisan_tpu/lint/cost.py``).

Per phase (the innermost ``round.*`` label an op ran under, ``-``
outside every label; both branches of every quiet gate, as the
reference's jaxpr holds both arms of a ``lax.cond``):

- **gathers / scatters**: ops of the gather family (``index``,
  ``gather``, ``index_select``, ``take_along_dim``, ``take``) and of the
  scatter family (``scatter*``, ``index_put``, ``index_add``,
  ``index_copy``, ``index_reduce``, ``index_fill``);
- **fetched**: gather output elements plus scatter update elements;
- **interm_bytes**: output bytes of every op, views excluded, whose
  output carries the node axis leading at rank >= 2 (``[n, ., .]``
  temporaries; ``[n]`` vectors and node-free tensors are noise);
- **eqns**: every dispatched aten op and host read (the reference
  counts jaxpr equations; the name is kept so rows and
  :func:`perfwatch.reconcile` read alike);
- **host_reads**: the reads a real round makes (branches it would skip
  excluded).

All of it is the port's own: aten ops are not jaxpr equations, so the
bytes and counts differ from the reference's census; the phase keys,
the superstep guard's verdicts and :func:`perfwatch.reconcile` are what
must agree.  ``census.kernels`` carries the hand-written kernel launches
(``interleave``), which bypass the dispatcher.
"""

from __future__ import annotations

from typing import NamedTuple

from partisan_tpu_torch.lint.core import (GATHER_OPS, Program, is_scatter,
                                          trace_program)


class PhaseCost(NamedTuple):
    """Cost census of one round phase (or a whole program)."""

    gathers: int = 0
    scatters: int = 0
    fetched: int = 0
    interm_bytes: int = 0
    eqns: int = 0
    host_reads: int = 0

    def __add__(self, other: "PhaseCost") -> "PhaseCost":
        return PhaseCost(*(a + b for a, b in zip(self, other)))

    @property
    def gather_scatter(self) -> int:
        return self.gathers + self.scatters


class Census(NamedTuple):
    phases: dict         # phase label -> PhaseCost ("-" = unphased)
    total: PhaseCost
    n: int               # the node-axis width the byte metric keyed on
    kernels: dict = {}   # hand-written kernel launches, by name

    def rows(self) -> list:
        """JSON-ready per-phase rows, heaviest interm_bytes first, with a
        trailing 'total' row."""
        out = []
        order = sorted(self.phases,
                       key=lambda p: -self.phases[p].interm_bytes)
        for ph in order:
            out.append({"phase": ph, **_row(self.phases[ph])})
        out.append({"phase": "total", **_row(self.total)})
        return out


def _row(c: PhaseCost) -> dict:
    return {
        "gather_eqns": c.gathers, "scatter_eqns": c.scatters,
        "gather_scatter_eqns": c.gather_scatter,
        "fetched_scalars": c.fetched,
        "interm_mib": round(c.interm_bytes / 2**20, 2),
        "eqns": c.eqns, "host_reads": c.host_reads,
    }


def census(ops, n: int, kernels: dict | None = None) -> Census:
    """Fold recorded ops (``Program.ops``) into a per-phase census;
    ``n`` keys the byte metric."""
    acc: dict[str, list] = {}
    for op in ops:
        c = acc.setdefault(op.phase, [0] * 6)
        c[4] += 1
        if op.name in GATHER_OPS:
            c[0] += 1
            c[2] += op.fetched
        elif is_scatter(op.name):
            c[1] += 1
            c[2] += op.fetched
        if not op.view:
            for shp, b in zip(op.shapes, op.nbytes):
                if len(shp) >= 2 and shp[0] == n:
                    c[3] += b
        if op.host_read and not op.shadow:
            c[5] += 1
    phases = {k: PhaseCost(*v) for k, v in acc.items()}
    total = PhaseCost()
    for c in phases.values():
        total = total + c
    return Census(phases=phases, total=total, n=n, kernels=dict(kernels or {}))


def census_program(prog: Program) -> Census:
    """Census a lint :class:`Program` (node width from its config)."""
    n = prog.cfg.n_nodes if prog.cfg is not None else -1
    return census(prog.ops, n, prog.kernels)


def state_memory_rows(state, specs, n_shards: int) -> list[dict]:
    """Resident bytes per device of a ``ClusterState`` placed by
    ``specs`` (``ShardedCluster._state_specs``: a leaf split on a node
    axis divides by ``n_shards``, a replicated one does not): one row
    per top-level field, heaviest first, and a trailing total row."""
    from partisan_tpu_torch import state_io
    from partisan_tpu_torch.parallel.sharded import OWN, REPL

    rows = []
    total = 0
    for field in state._fields:
        leaves = [x for _, x in state_io.flatten(getattr(state, field))]
        if not leaves:
            continue
        spec_leaves = [x for _, x in state_io.flatten(getattr(specs, field))]
        if len(spec_leaves) != len(leaves):
            raise ValueError(f"state/spec leaf mismatch under {field!r}: "
                             f"{len(leaves)} vs {len(spec_leaves)}")
        b = sum(x.numel() * x.element_size()
                // (1 if spec in (REPL, OWN) else n_shards)
                for x, spec in zip(leaves, spec_leaves))
        rows.append({"plane": field, "mib_per_device": round(b / 2**20, 3)})
        total += b
    rows.sort(key=lambda r: -r["mib_per_device"])
    rows.append({"plane": "total", "mib_per_device": round(total / 2**20, 3)})
    return rows


def resident_memory_rows(state) -> list[dict]:
    """Resident bytes of a state on its one device: the one-shard case
    of :func:`state_memory_rows` (what tools/soak_report.py stamps on a
    soak in the reference)."""
    from partisan_tpu_torch import state_io
    from partisan_tpu_torch.parallel.sharded import REPL

    return state_memory_rows(
        state, state_io.tree_map(lambda _: REPL, state), 1)


def bench_cfg(n: int = 32_768, *, width_operand: bool = False):
    """The PLAIN bench config (HyParView + Plumtree, planes off:
    bench.py's capacity knobs), the one source for the census of the
    bench round and its measured phase attribution."""
    from partisan_tpu_torch.config import (Config, HyParViewConfig,
                                           PlumtreeConfig)

    return Config(n_nodes=n, seed=1, peer_service_manager="hyparview",
                  msg_words=16, partition_mode="groups",
                  max_broadcasts=8, inbox_cap=16, emit_compact=32,
                  timer_stagger=False, width_operand=width_operand,
                  hyparview=HyParViewConfig(isolation_window_ms=25_000),
                  plumtree=PlumtreeConfig(push_slots=2, lazy_cap=4))


def bench_round_program(n: int = 32_768, *, width_operand: bool = False,
                        device=None, cluster=None, state=None) -> Program:
    """Census one round of the bench config at ``n`` nodes, on
    ``state`` (default: the cluster's init state) of ``cluster``
    (default: a fresh one on ``device``, the card by default)."""
    from partisan_tpu_torch.cluster import Cluster
    from partisan_tpu_torch.models.plumtree import Plumtree

    cl = cluster if cluster is not None else Cluster(
        bench_cfg(n, width_operand=width_operand), model=Plumtree(),
        device=device)
    st = cl.init() if state is None else state
    name = f"round/bench-{cl.cfg.n_nodes}" + (
        "+width" if cl.cfg.width_operand else "")
    return trace_program(name, cl.step, st, cl.cfg)
