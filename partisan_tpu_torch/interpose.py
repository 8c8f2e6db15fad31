"""Interposition layer: drop / rewrite / observe / delay hooks on the send
path (port of ``partisan_tpu/interpose.py``).

An interposition is a transform over the round's emitted record stack
(a ``Planes`` of ``[n, E]`` word planes), applied between emission and
the fault stage: emit -> [interposition chain] -> faults -> route.  Its
dynamic state (the delay buffer, the omission schedule) rides in
``ClusterState.interpose``.  Predicates and rewrites take
``(cfg, ctx, emitted)`` and index word planes (``emitted[T.W_KIND]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops


def _drop_where(emitted: plane_ops.Planes, mask: torch.Tensor
                ) -> plane_ops.Planes:
    """Clear kind (mark empty) where ``mask`` [n, E] is True."""
    return plane_ops.set_word(emitted, T.W_KIND,
                              torch.where(mask, 0, emitted[T.W_KIND]))


@dataclasses.dataclass(frozen=True)
class Drop:
    """Drop messages matching ``pred(cfg, ctx, emitted) -> bool[n, E]``."""

    pred: Callable

    def init(self, cfg, comm) -> Any:
        return ()

    def apply(self, cfg, comm, state, emitted, ctx):
        return state, _drop_where(emitted, self.pred(cfg, ctx, emitted))


@dataclasses.dataclass(frozen=True)
class Rewrite:
    """Arbitrary rewrite: ``fn(cfg, ctx, emitted) -> emitted``."""

    fn: Callable

    def init(self, cfg, comm) -> Any:
        return ()

    def apply(self, cfg, comm, state, emitted, ctx):
        return state, self.fn(cfg, ctx, emitted)


def _as_state(x, device) -> torch.Tensor:
    """A state leaf with the reference's dtype: Python ints become int32
    and floats float32, as ``jnp.asarray`` makes them."""
    t = torch.as_tensor(x, device=device)
    if isinstance(x, bool):
        return t
    if isinstance(x, int):
        return t.to(torch.int32)
    if isinstance(x, float):
        return t.to(torch.float32)
    return t


@dataclasses.dataclass(frozen=True)
class Observe:
    """Side-effect-free probe: ``fn(cfg, ctx, emitted) -> aux`` folded
    into the state by ``combine(state, aux)``."""

    fn: Callable
    combine: Callable
    init_state: Any = 0

    def init(self, cfg, comm) -> Any:
        return _as_state(self.init_state, comm.device)

    def apply(self, cfg, comm, state, emitted, ctx):
        return self.combine(state, self.fn(cfg, ctx, emitted)), emitted


@dataclasses.dataclass(frozen=True)
class OmissionSchedule:
    """Scripted per-round, per-slot send omissions — the executor of
    filibuster schedules and trace replay.

    ``drops``: host bool[T, n, E]; row i applies at absolute round
    ``start + i``.  Rounds outside [start, start+T) read an appended
    all-pass row.  A schedule with fewer than n sender rows passes the
    rest; its slot axis is padded with passes or clipped to the round's
    emission width."""

    drops: Any
    start: int = 0

    def init(self, cfg, comm) -> torch.Tensor:
        d = torch.as_tensor(np.asarray(self.drops, dtype=np.bool_),
                            device=comm.device)
        if d.dim() != 3:
            raise ValueError(
                f"OmissionSchedule drops must be rank-3 [T, n, E] "
                f"(row i = absolute round start+i); got shape "
                f"{tuple(d.shape)}")
        return torch.cat([d, torch.zeros((1,) + tuple(d.shape[1:]),
                                         dtype=torch.bool,
                                         device=d.device)])

    def apply(self, cfg, comm, state, emitted, ctx):
        n_pad = state.shape[0] - 1      # the appended all-pass row
        t = ctx.rnd - self.start
        t = torch.where((t >= 0) & (t < n_pad), t, n_pad)
        sched = state[t.to(torch.int64)]
        rows, width = sched.shape
        if rows < comm.n_global:        # partial schedules: rest passes
            sched = torch.cat([sched, sched.new_zeros(
                (comm.n_global - rows, width))])
        # this shard's sender rows
        lo = comm.node_offset
        local = sched[lo:lo + comm.n_local]
        e = emitted[T.W_KIND].shape[1]
        if width < e:
            local = torch.cat([local, local.new_zeros(
                (comm.n_local, e - width))], dim=1)
        return state, _drop_where(emitted, local[:, :e])


def _hold_state(cfg, comm, cap: int) -> dict:
    dev = comm.device
    return {"buf": msg_ops.zero_wire(cfg, (comm.n_local, cap), device=dev),
            "due": torch.full((comm.n_local, cap), -1, dtype=torch.int32,
                              device=dev),
            "missed": torch.zeros((), dtype=torch.int32, device=dev)}


@dataclasses.dataclass(frozen=True)
class Delay:
    """``$delay``: hold messages matching ``pred`` for ``rounds`` rounds,
    then re-inject them on the send path flagged ``mark_flag`` (so a
    predicate can skip them).  ``cap`` bounds held messages per node;
    overflow passes undelayed and is counted in ``missed``."""

    pred: Callable
    rounds: int = 1
    cap: int = 8
    mark_flag: int = T.F_RETRANSMISSION

    def init(self, cfg, comm) -> dict:
        return _hold_state(cfg, comm, self.cap)

    def apply(self, cfg, comm, state, emitted, ctx):
        hold = self.pred(cfg, ctx, emitted) & (emitted[T.W_KIND] != 0)
        rounds_row = torch.full((hold.shape[0],), self.rounds,
                                dtype=torch.int32, device=hold.device)
        return _hold_release(comm, state, emitted, ctx, hold=hold,
                             rounds_row=rounds_row, cap=self.cap,
                             mark_flag=self.mark_flag)


def _hold_release(comm, state, emitted, ctx, *, hold, rounds_row, cap,
                  mark_flag):
    """The hold buffer behind :class:`Delay` and :class:`StragglerDelay`:
    release matured messages, capture the ``hold``-selected ones into
    free slots for ``rounds_row[node]`` rounds (the k-th held message of
    a row takes its k-th free slot), append the releases to this round's
    emissions.  Extra state keys pass through."""
    buf, due = state["buf"], state["due"]
    dev = due.device

    # 1. Release matured messages.
    ripe = (due >= 0) & (due <= ctx.rnd)
    released = _drop_where(buf, ~ripe)
    released = plane_ops.set_word(released, T.W_FLAGS, torch.where(
        ripe, released[T.W_FLAGS] | mark_flag, released[T.W_FLAGS]))
    buf = _drop_where(buf, ripe)
    due = torch.where(ripe, -1, due)

    # 2. Capture newly matching messages into free slots.
    free = due < 0
    hold_rank = torch.cumsum(hold, dim=1) - 1
    free_rank = torch.cumsum(free, dim=1) - 1
    n_free = free.sum(dim=1)
    can = hold & (hold_rank < n_free[:, None])
    n = free.shape[0]
    slot_of_rank = torch.full((n, cap + 1), cap, dtype=torch.int64,
                              device=dev).scatter_(
        1, torch.where(free, free_rank, cap),
        torch.arange(cap, device=dev).expand(n, cap))[:, :cap]
    tgt = torch.where(can, torch.gather(slot_of_rank, 1,
                                        hold_rank.clamp(0, cap - 1)), cap)
    buf = plane_ops.scatter_rows(buf, tgt, emitted)
    new_due = (ctx.rnd + rounds_row)[:, None].expand(tgt.shape)
    due = plane_ops.scatter_rows(plane_ops.Planes([due]), tgt,
                                 plane_ops.Planes([new_due]))[0]
    emitted = _drop_where(emitted, can)

    # 3. Append the released messages to this round's emissions.
    out = plane_ops.concat([emitted, released], dim=1)
    missed = state["missed"] + comm.allsum(
        (hold & ~can).sum().to(torch.int32))
    return {**state, "buf": buf, "due": due, "missed": missed}, out


@dataclasses.dataclass(frozen=True)
class StragglerDelay:
    """Slow-node stage: every live message a node emits is held
    ``mult[node]`` rounds (``mult`` int32[n] in the state, 0 = pass);
    ``workload.Stragglers`` scripts it mid-run."""

    cap: int = 8
    mark_flag: int = T.F_DELAY_RELEASED

    def init(self, cfg, comm) -> dict:
        return {"mult": torch.zeros(comm.n_local, dtype=torch.int32,
                                    device=comm.device),
                **_hold_state(cfg, comm, self.cap)}

    def apply(self, cfg, comm, state, emitted, ctx):
        mult = state["mult"]
        hold = (emitted[T.W_KIND] != 0) & (mult[:, None] > 0) \
            & ((emitted[T.W_FLAGS] & self.mark_flag) == 0)
        return _hold_release(comm, state, emitted, ctx, hold=hold,
                             rounds_row=mult, cap=self.cap,
                             mark_flag=self.mark_flag)


def _not_yet_released(cfg, ctx, emitted) -> torch.Tensor:
    """Every live message on its first send-path pass."""
    return (emitted[T.W_KIND] != 0) \
        & ((emitted[T.W_FLAGS] & T.F_DELAY_RELEASED) == 0)


def config_delays(cfg, inner: Any = None) -> Any:
    """Install ``egress_delay_ms`` / ``ingress_delay_ms`` as a send-path
    Delay stage after any user interposition (``inner`` unchanged when
    neither key is set).  The hold buffer defaults to
    ``max(64, 2 * rounds * max(inbox_cap, emit_cap))`` slots per node
    (``delay_buf_cap`` overrides)."""
    rounds = cfg.send_delay_rounds
    if rounds == 0:
        return inner
    cap = cfg.delay_buf_cap or max(64, 2 * rounds
                                   * max(cfg.inbox_cap, cfg.emit_cap))
    delay = Delay(pred=_not_yet_released, rounds=rounds, cap=cap,
                  mark_flag=T.F_DELAY_RELEASED)
    return delay if inner is None else Chain([inner, delay])


@dataclasses.dataclass(frozen=True)
class Chain:
    """Applies each interposition in order; the state is the tuple of
    theirs."""

    items: Sequence[Any]

    def init(self, cfg, comm) -> tuple:
        return tuple(i.init(cfg, comm) for i in self.items)

    def apply(self, cfg, comm, state, emitted, ctx):
        out_states = []
        for item, s in zip(self.items, state):
            s, emitted = item.apply(cfg, comm, s, emitted, ctx)
            out_states.append(s)
        return tuple(out_states), emitted


def specs(interpose, state, shard, repl):
    """The sharded cluster's placement of an interposition state: hold
    buffers shard on the node axis, counters, observers and omission
    schedules (which cover every sender) replicate."""
    if isinstance(interpose, Chain):
        return tuple(specs(i, s, shard, repl)
                     for i, s in zip(interpose.items, state))
    if isinstance(state, dict):
        return {k: repl if k == "missed" else shard for k in state}
    if isinstance(state, torch.Tensor):
        return repl
    return ()
