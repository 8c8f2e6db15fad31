"""Message-causality analysis (reference src/partisan_analysis.erl; port
of ``partisan_tpu/analysis.py``, host-side over a recorded ``Trace``).

The reference runs a Core-Erlang static analysis over protocol source to
derive message-causality annotations — which message types a protocol
emits in reaction to which — written to ``analysis/partisan-causality-
<mod>`` and combined with human annotations
(``annotations/partisan-annotations-*``: causality rules + background
message sets) to prune filibuster's schedule space
(schedule_valid_causality, filibuster_SUITE.erl:1023).

The sim's protocols are tensor programs, not source to walk;
the equivalent evidence source is the trace itself: because rounds are
deterministic, the reaction structure is derived from recorded
executions —

- ``reaction_graph``: kind-level causality edges (a node that received
  kind A emitted kind B next round) — a sound over-approximation of the
  reference's per-message causality on any behavior the trace exercises,
- ``background_kinds``: kinds emitted without any receipt (timer-driven
  heartbeats/gossip — the annotation files' background sets),
- annotation persistence in JSON mirroring the annotations/ layout,
- ``prunable``: the schedule-classification predicate — omissions of
  messages whose kind cannot (transitively) cause a candidate kind are
  equivalent w.r.t. that candidate and can be skipped
  (classify_schedule, filibuster_SUITE.erl:1155-1192).
"""

from __future__ import annotations

import json

import numpy as np

from partisan_tpu_torch import types as T
from partisan_tpu_torch.trace import Trace


def _kind_name(k: int) -> str:
    try:
        return T.MsgKind(int(k)).name
    except ValueError:
        return f"KIND<{int(k)}>"


def reaction_graph(trace: Trace) -> dict[str, set[str]]:
    """kind -> set of kinds it can cause (next-round reactions).

    For every round r, messages DELIVERED in r (sent and not dropped)
    are receipts processed at round r+1; every kind a receiver emits at
    r+1 gets a causality edge from every kind it received.  Conservative
    (per-node, not per-message), like the reference's escape analysis
    which also over-approximates (partisan_analysis.erl:24-60).

    ABSENCE-triggered reactions cannot appear in a fault-free trace; the
    known such mechanism — ack-lane retransmission (losing an ACK makes
    the sender re-emit the acked message) — is added as explicit
    ``ACK -> kind`` edges for every F_ACK_REQUIRED kind observed.  Other
    absence-triggered behaviors in custom models are NOT derivable from
    traces: reaction-graph pruning is a heuristic schedule reducer (like
    the reference's hand-written annotation files), not a proof.
    """
    sent = trace.sent
    delivered = trace.delivered()
    n_rounds, n_nodes = trace.n_rounds, trace.n_nodes
    graph: dict[str, set[str]] = {}
    # receipts[r][node] = kinds delivered TO node during round r
    for r in range(n_rounds - 1):
        d = delivered[r]
        recv: dict[int, set[int]] = {}
        mask = d[..., T.W_KIND] != 0
        for i, e in zip(*np.nonzero(mask)):
            m = d[i, e]
            recv.setdefault(int(m[T.W_DST]), set()).add(int(m[T.W_KIND]))
        nxt = sent[r + 1]
        nmask = nxt[..., T.W_KIND] != 0
        for i, e in zip(*np.nonzero(nmask)):
            src = int(nxt[i, e, T.W_SRC])
            out_kind = _kind_name(nxt[i, e, T.W_KIND])
            for in_kind in recv.get(src, ()):
                graph.setdefault(_kind_name(in_kind), set()).add(out_kind)
    # ack-retransmission implication edges (see docstring)
    acked_mask = (sent[..., T.W_KIND] != 0) \
        & (sent[..., T.W_FLAGS] & T.F_ACK_REQUIRED != 0)
    for k in np.unique(sent[..., T.W_KIND][acked_mask]):
        graph.setdefault("ACK", set()).add(_kind_name(k))
    return graph


def background_kinds(trace: Trace) -> set[str]:
    """Kinds some node emits in a round where it received NOTHING —
    timer-driven traffic (the annotation files' background-message
    sets; e.g. gossip/heartbeat kinds)."""
    sent = trace.sent
    delivered = trace.delivered()
    out: set[str] = set()
    for r in range(trace.n_rounds):
        if r == 0:
            got = set()
        else:
            d = delivered[r - 1]
            got = {int(m) for m in
                   np.unique(d[..., T.W_DST][d[..., T.W_KIND] != 0])}
        s = sent[r]
        mask = s[..., T.W_KIND] != 0
        for i, e in zip(*np.nonzero(mask)):
            if int(s[i, e, T.W_SRC]) not in got:
                out.add(_kind_name(s[i, e, T.W_KIND]))
    return out


def closure(graph: dict[str, set[str]]) -> dict[str, set[str]]:
    """Transitive closure of the reaction graph."""
    out = {k: set(v) for k, v in graph.items()}
    changed = True
    while changed:
        changed = False
        for k, vs in out.items():
            ext = set()
            for v in vs:
                ext |= out.get(v, set())
            if not ext <= vs:
                vs |= ext
                changed = True
    return out


def prunable(graph: dict[str, set[str]], omitted_kind: str,
             target_kind: str) -> bool:
    """True if omitting a message of ``omitted_kind`` provably cannot
    affect messages of ``target_kind`` — the schedule-equivalence test
    (schedules differing only in such omissions are equivalent,
    filibuster_SUITE.erl:1155-1192)."""
    if omitted_kind == target_kind:
        return False
    return target_kind not in closure(graph).get(omitted_kind, set())


def ensemble_reaction(traces) -> tuple[dict[str, set[str]], dict]:
    """Union of reaction graphs over an ENSEMBLE of traces (multiple
    seeds × fault settings), with a coverage report.

    A single trace under-approximates the reaction structure: an edge a
    run never exercised is invisible, so pruning against it can silently
    skip schedules that would find bugs — whereas the reference's STATIC
    source analysis over-approximates and is therefore sound
    (src/partisan_analysis.erl:24-60).  Unioning over diverse traces
    narrows (but cannot close — absence-triggered reactions never appear
    as receipt edges in ANY trace) that gap; the coverage report makes
    the evidence base explicit:

    - ``traces``: how many executions contributed,
    - ``edges``: total distinct causality edges,
    - ``new_edges_per_trace``: edges first contributed by each trace in
      order — a tail of zeros suggests (but does not prove) saturation,
    - ``background``: union of timer/absence-driven kinds (these must
      never justify pruning: their triggers are invisible to receipt
      analysis).
    """
    graph: dict[str, set[str]] = {}
    background: set[str] = set()
    new_counts: list[int] = []
    n_traces = 0
    for tr in traces:
        n_traces += 1
        g = reaction_graph(tr)
        before = sum(len(v) for v in graph.values())
        for k, vs in g.items():
            graph.setdefault(k, set()).update(vs)
        background |= background_kinds(tr)
        new_counts.append(sum(len(v) for v in graph.values()) - before)
    coverage = {
        "traces": n_traces,
        "edges": sum(len(v) for v in graph.values()),
        "new_edges_per_trace": new_counts,
        "background": sorted(background),
    }
    return graph, coverage


# ---------------------------------------------------------------------------
# annotation persistence (annotations/partisan-annotations-* layout)
# ---------------------------------------------------------------------------

def annotations(trace: Trace) -> dict:
    g = reaction_graph(trace)
    return {
        "causality": {k: sorted(v) for k, v in sorted(g.items())},
        "background": sorted(background_kinds(trace)),
    }


def save_annotations(trace: Trace, path, *, protocol: str = "") -> None:
    doc = {"protocol": protocol, **annotations(trace)}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def load_annotations(path) -> dict:
    with open(path) as f:
        doc = json.load(f)
    doc["causality"] = {k: set(v) for k, v in doc["causality"].items()}
    doc["background"] = set(doc["background"])
    return doc
