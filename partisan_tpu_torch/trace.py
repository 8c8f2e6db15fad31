"""Trace recording / rendering / replay — the trace-orchestrator analogue
(port of ``partisan_tpu/trace.py``; host-side numpy, the same npz format
and ``TRACE_VERSION``, so a trace saved by either package loads in the
other).

The reference's ``partisan_trace_orchestrator`` records typed message
events from every node (partisan_trace_orchestrator.erl:80-86), renders
them as send/receive/DROPPED lines (:250-323), persists them via dets
(partisan_trace_file.erl:26-61), and replays them by enforcing the
recorded delivery order (:197-240).

In the simulator determinism is native (SURVEY.md §5.1): the trace IS the
per-round send-tensor captured by ``Cluster.record`` — ``TraceRound(sent,
dropped)`` stacked over rounds.  Replay = re-running the same
configuration (same seed ⇒ identical rounds), or re-running with the
recorded drops compiled into an ``interpose.OmissionSchedule`` so the
delivery schedule is enforced even under different fault settings —
exactly filibuster's preloaded-omission mechanism
(partisan_trace_orchestrator.erl:598-650).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from partisan_tpu_torch import types as T

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One send-path event (the `pre_interposition_fun` record analogue)."""

    rnd: int
    src: int
    dst: int
    kind: int
    channel: int
    clock: int
    slot: int          # (sender, emission-slot) coordinate within the round
    dropped: bool      # cut by the fault stage before delivery
    payload: tuple     # protocol payload words

    @property
    def kind_name(self) -> str:
        try:
            return T.MsgKind(self.kind).name
        except ValueError:
            return f"KIND<{self.kind}>"


class Trace:
    """A recorded execution: ``sent`` int32[T, n, E, W], ``dropped``
    bool[T, n, E] (host numpy)."""

    def __init__(self, sent, dropped, rounds=None) -> None:
        self.sent = np.asarray(sent)
        self.dropped = np.asarray(dropped)
        self.rounds = (np.arange(self.sent.shape[0], dtype=np.int32)
                       if rounds is None else np.asarray(rounds))
        assert self.sent.ndim == 4 and self.dropped.ndim == 3
        assert self.sent.shape[:3] == self.dropped.shape
        assert self.rounds.shape == (self.sent.shape[0],)

    # ---- shape ---------------------------------------------------------
    @property
    def n_rounds(self) -> int:
        return self.sent.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.sent.shape[1]

    @property
    def emit_width(self) -> int:
        return self.sent.shape[2]

    @property
    def start(self) -> int:
        """Absolute round of the first recorded round."""
        return int(self.rounds[0])

    # ---- event access (trace/1 record analogue) ------------------------
    def events(self, *, include_dropped: bool = True) -> Iterator[TraceEvent]:
        snt, drp = self.sent, self.dropped
        rs, ns, es = np.nonzero(snt[..., T.W_KIND])
        for r, n, e in zip(rs, ns, es):
            m = snt[r, n, e]
            if not include_dropped and drp[r, n, e]:
                continue
            yield TraceEvent(
                rnd=int(self.rounds[r]), src=int(m[T.W_SRC]),
                dst=int(m[T.W_DST]),
                kind=int(m[T.W_KIND]), channel=int(m[T.W_CHANNEL]),
                clock=int(m[T.W_CLOCK]), slot=int(e),
                dropped=bool(drp[r, n, e]),
                payload=tuple(int(w) for w in m[T.HDR_WORDS:]),
            )

    def delivered(self) -> np.ndarray:
        """sent with fault-dropped slots cleared — what actually hit the
        wire (for replay equivalence checks)."""
        out = self.sent.copy()
        out[..., T.W_KIND] = np.where(self.dropped, 0, out[..., T.W_KIND])
        return out

    # ---- rendering (print/0, :250-323) ---------------------------------
    def render(self, *, limit: int | None = None) -> str:
        lines = []
        total = int((self.sent[..., T.W_KIND] != 0).sum())
        for i, ev in enumerate(self.events()):
            if limit is not None and i >= limit:
                lines.append(f"... ({total} events)")
                break
            tag = "DROPPED " if ev.dropped else ""
            lines.append(
                f"r={ev.rnd:<4} {tag}{ev.src} => {ev.dst} "
                f"{ev.kind_name} ch={ev.channel} clock={ev.clock} "
                f"payload={list(ev.payload)}")
        return "\n".join(lines)

    def tail(self, k: int) -> "Trace":
        """The last ``k`` recorded rounds as a Trace — the window a
        flight-recorder ring of size k retains (latency.flight_trace),
        for capture-vs-recorder equivalence checks.  ``k <= 0`` yields
        an empty zero-round Trace (an explicit start index, not ``-k:``
        — ``[-0:]`` would silently return everything)."""
        k = max(0, min(k, self.n_rounds))
        lo = self.n_rounds - k
        return Trace(self.sent[lo:], self.dropped[lo:], self.rounds[lo:])

    # ---- persistence (partisan_trace_file.erl:26-61) -------------------
    def save(self, path) -> None:
        np.savez_compressed(path, version=TRACE_VERSION, sent=self.sent,
                            dropped=self.dropped, rounds=self.rounds)

    @classmethod
    def load(cls, path) -> "Trace":
        with np.load(path) as z:
            if int(z["version"]) != TRACE_VERSION:
                raise ValueError(f"trace version {int(z['version'])} != "
                                 f"{TRACE_VERSION}")
            return cls(z["sent"], z["dropped"], z["rounds"])

    # ---- replay / schedule synthesis -----------------------------------
    def omission_schedule(self) -> np.ndarray:
        """bool[T, n, E] — the recorded fault drops as an explicit
        schedule; feed to ``interpose.OmissionSchedule`` to replay this
        execution's deliveries under zeroed stochastic faults."""
        return self.dropped.copy()

    def matches(self, other: "Trace") -> bool:
        """Same delivered traffic (the replay fidelity check)?"""
        a, b = self.delivered(), other.delivered()
        return a.shape == b.shape and bool(np.array_equal(a, b))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_capture(traced) -> Trace:
    """Build a Trace from ``Cluster.record``'s stacked TraceRound (torch
    tensors on any device, copied to the host in their ``[T, n, E, W]``
    layout)."""
    return Trace(_host(traced.sent), _host(traced.dropped),
                 _host(traced.rnd))


def schedule_from_events(events, n_rounds: int, n_nodes: int,
                         emit_width: int, *, start: int = 0) -> np.ndarray:
    """Compile (absolute-rnd, src, slot) omission coordinates into a dense
    schedule bool[T, n, E] whose row 0 is absolute round ``start`` — feed
    to ``interpose.OmissionSchedule(sched, start=start)`` (the
    classify/preload step of filibuster schedule execution,
    filibuster_SUITE.erl:1155-1192 → trace orchestrator preload)."""
    sched = np.zeros((n_rounds, n_nodes, emit_width), np.bool_)
    for (r, s, e) in events:
        if 0 <= r - start < n_rounds:
            sched[r - start, s, e] = True
    return sched
