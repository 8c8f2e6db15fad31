"""Streaming ingress: a double-buffered host-to-card request lane at the
soak engine's chunk boundaries (port of ``partisan_tpu/ingress.py``).

Every other message is born inside the round.  This lane carries
requests that come from outside it (a recorded trace, a live front end)
and still ride the deterministic round:

- **The host ring** (:class:`IngressRing`) is bounded and double
  buffered: producers ``offer`` into the front buffer while the engine
  drains the batch taken at the last boundary; offers past ``ring_cap``
  shed (tail-drop), counted on the host.
- **The boundary drain** (:class:`IngressFeed`) takes requests FIFO
  under per-channel quotas (halved per backpressure level when that
  controller is on) and a release-round window, stages them into the
  per-node buffer on the card (:func:`stage`: one host read, one copy to
  the card and four scatters), and journals the batch.  The JSON-lines
  journal (:class:`Journal`, :func:`write_trace`) is both a replay file
  (a recorded trace is a second arrival mode) and the resume contract: a
  rewound or restarted soak re-injects the journaled batch at its
  boundary instead of draining the ring again.
- **The release** (:func:`release`, in ``cluster.round_body``): each
  staged request emits at its release round from its source row as an
  APP record and rides every later stage.  A request whose source row
  is dead or inactive then, or that found its row's buffer full at the
  boundary, is shed on the card and counted emitted and dropped under
  the metrics plane's ``ingress_shed`` cause, so conservation holds.

``IngressConfig(enabled=False)``, the default, keeps the leaf ``()``.
The journal's lines are byte for byte the reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import metrics as metrics_mod
from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops

_I32 = torch.int32


class Request(NamedTuple):
    """One external request: released at absolute round ``rnd`` (clamped
    forward when already past), sent by ``src`` to ``dst`` on
    ``channel`` with one payload word."""

    rnd: int
    src: int
    dst: int
    channel: int = 0
    payload: int = 0


class IngressState(NamedTuple):
    """The per-node buffer of ``S = IngressConfig.slots`` staged requests
    and the shed and injection ledgers (int32)."""

    dst: torch.Tensor        # [n, S] destination (-1 = empty)
    channel: torch.Tensor    # [n, S]
    payload: torch.Tensor    # [n, S]
    release: torch.Tensor    # [n, S] absolute release round (-1 = empty)
    shed_pend: torch.Tensor  # [C] boundary sheds (buffer full) the next
    #                          round books as emitted and dropped
    shed_total: torch.Tensor  # cumulative sheds on the card
    injected: torch.Tensor   # cumulative requests emitted


def enabled(cfg) -> bool:
    return cfg.ingress.enabled


def init(cfg, comm) -> IngressState:
    n, S, dev = comm.n_local, cfg.ingress.slots, comm.device

    def scalar(v):
        return torch.tensor(v, dtype=_I32, device=dev)

    return IngressState(
        dst=torch.full((n, S), -1, dtype=_I32, device=dev),
        channel=torch.zeros((n, S), dtype=_I32, device=dev),
        payload=torch.zeros((n, S), dtype=_I32, device=dev),
        release=torch.full((n, S), -1, dtype=_I32, device=dev),
        shed_pend=torch.zeros(cfg.n_channels, dtype=_I32, device=dev),
        shed_total=scalar(0), injected=scalar(0))


def release(cfg, comm, gs: IngressState, ctx):
    """The round's release stage: every staged request whose release round
    has come (``release <= rnd``) emits from its row as one ``[n, S]`` APP
    block for the round's emission concatenate, and its slot clears.  A
    due request whose row is dead or inactive is shed and joins the
    boundary's pending sheds.  Returns ``(state', block, shed_round,
    shed_ch)``: the round's shed count (int32) and its per-channel split
    (int32[C]), which the round adds to emitted and to the
    ``ingress_shed`` drops."""
    C = cfg.n_channels
    gids = comm.local_ids()
    due = (gs.release >= 0) & (gs.release <= ctx.rnd)
    alive = ctx.alive[:, None]
    fire = due & alive
    stale = due & ~alive
    ch = gs.channel.clamp(0, C - 1)
    block = msg_ops.build(cfg, T.MsgKind.APP, gids[:, None],
                          torch.where(fire, gs.dst, -1), channel=ch,
                          payload=(gs.payload,))
    # the ledgers are replicated: this shard's counts reduce first
    n_fire = comm.allsum(fire.sum().to(_I32))
    shed_ch = gs.shed_pend + comm.allsum(metrics_mod.bin_count(ch, stale, C))
    shed_round = shed_ch.sum().to(_I32)
    out = IngressState(
        dst=torch.where(due, -1, gs.dst),
        channel=torch.where(due, 0, gs.channel),
        payload=torch.where(due, 0, gs.payload),
        release=torch.where(due, -1, gs.release),
        shed_pend=torch.zeros_like(gs.shed_pend),
        shed_total=gs.shed_total + shed_round,
        injected=gs.injected + n_fire)
    return out, block, shed_round, shed_ch


def poll(gs: IngressState) -> dict:
    """Staged requests and the cumulative ledgers (one host read)."""
    staged, injected, shed = torch.stack(
        [(gs.release >= 0).sum().to(_I32), gs.injected,
         gs.shed_total]).tolist()
    return {"staged": staged, "injected": injected, "shed": shed}


# ---------------------------------------------------------------------------
# The host ring
# ---------------------------------------------------------------------------

class IngressRing:
    """Bounded double-buffered request ring.  ``offer`` appends to the
    front buffer; ``begin_drain`` hands the engine this boundary's batch
    (leftovers first) and starts a fresh front; ``defer`` puts requests a
    quota held back at the head of the line for the next boundary.
    Offers into a full ring shed (tail-drop), counted in ``offered`` and
    ``shed_full``."""

    def __init__(self, cap: int):
        if cap < 1:
            raise ValueError(f"ring cap must be >= 1, got {cap}")
        self.cap = cap
        self._front: collections.deque = collections.deque()
        self._back: collections.deque = collections.deque()
        self.offered = 0
        self.shed_full = 0

    def __len__(self) -> int:
        return len(self._front) + len(self._back)

    def offer(self, reqs) -> int:
        """Enqueue requests; returns how many were accepted."""
        accepted = 0
        for r in reqs:
            self.offered += 1
            if len(self) >= self.cap:
                self.shed_full += 1
                continue
            self._front.append(Request(*r))
            accepted += 1
        return accepted

    def begin_drain(self) -> list:
        """Swap buffers; return this boundary's batch, FIFO."""
        batch = list(self._back) + list(self._front)
        self._back = collections.deque()
        self._front = collections.deque()
        return batch

    def defer(self, reqs) -> None:
        """Requests held back this boundary drain first at the next."""
        self._back.extend(reqs)


# ---------------------------------------------------------------------------
# The journal (the recorded-trace file format)
# ---------------------------------------------------------------------------

class Journal:
    """Append-only JSON lines, one per boundary that staged anything:
    ``{"round": r, "requests": [[rnd, src, dst, channel, payload],
    ...]}``.  ``load`` turns a journal or trace back into round-keyed
    batches."""

    def __init__(self, path):
        self.path = os.fspath(path)

    def append(self, rnd: int, reqs) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({
                "round": int(rnd),
                "requests": [[int(v) for v in Request(*r)]
                             for r in reqs]}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def load(path) -> dict:
        """``{round: [Request, ...]}`` (empty when the file is absent)."""
        out: dict = {}
        path = os.fspath(path)
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                out[int(row["round"])] = [Request(*r)
                                          for r in row["requests"]]
        return out


def write_trace(path, reqs, every: int = 1) -> int:
    """Write requests as a replay trace, batched onto boundary rounds (a
    request released at round r goes to the batch of the largest multiple
    of ``every`` <= r).  Returns the number of batches."""
    byrnd: dict = {}
    for r in reqs:
        r = Request(*r)
        byrnd.setdefault((r.rnd // every) * every, []).append(r)
    j = Journal(path)
    if os.path.exists(j.path):
        os.unlink(j.path)
    for rnd in sorted(byrnd):
        j.append(rnd, byrnd[rnd])
    return len(byrnd)


# ---------------------------------------------------------------------------
# The boundary feed
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IngressFeed:
    """What the soak engine calls at every chunk boundary
    (``Soak.ingress``).  Its modes compose:

    - **live**: a :class:`IngressRing` drained under the quotas and an
      optional release-round ``window`` (requests due at or past
      ``r + window`` stay in the ring);
    - **journaled**: every staged batch is recorded in memory (a rewound
      retry re-injects it and leaves the ring alone) and, with
      ``journal_path``, appended to that file (the fresh-process resume);
    - **replay**: no ring, a journal or trace file only.  Its rounds are
      boundary rounds: the soak's chunk sizer clips at
      :meth:`next_after`, as at storm events.
    """

    ring: IngressRing | None = None
    journal_path: str | os.PathLike | None = None
    window: int = 0               # 0 = stage everything due eventually

    def __post_init__(self):
        self._journal = (Journal(self.journal_path)
                         if self.journal_path is not None else None)
        # boundary round -> staged batch, seeded from the file
        self._recorded = (Journal.load(self.journal_path)
                          if self.journal_path is not None else {})

    def next_after(self, rnd: int):
        """The smallest recorded boundary round after ``rnd`` (None when
        none is left)."""
        later = [r for r in self._recorded if r > rnd]
        return min(later) if later else None

    def prune(self, before_rnd: int) -> int:
        """Drop in-memory records below ``before_rnd`` (called at every
        checkpoint: no rewind goes further back, and the file is kept).
        Returns how many were dropped."""
        stale = [r for r in self._recorded if r < before_rnd]
        for r in stale:
            del self._recorded[r]
        return len(stale)

    def _quotas(self, cfg, state):
        """Per-channel admissions this boundary (None = no limit): the
        base quota, shifted right by each channel's backpressure level
        when that controller is on."""
        base = cfg.ingress.quota
        if base <= 0:
            return None
        q = [base] * cfg.n_channels
        ctrl = state.control
        if ctrl != () and ctrl.backpressure != ():
            press = ctrl.backpressure.press.reshape(-1).tolist()
            for c in range(min(cfg.n_channels, len(press))):
                q[c] = max(1, base >> int(press[c]))
        return q

    def _select(self, cfg, batch, r: int, quotas):
        """FIFO admission under the quotas and the window: (admitted,
        deferred)."""
        take, defer = [], []
        used = [0] * cfg.n_channels
        for req in batch:
            req = Request(*req)
            ch = min(max(int(req.channel), 0), cfg.n_channels - 1)
            if self.window > 0 and req.rnd >= r + self.window:
                defer.append(req)
            elif quotas is not None and used[ch] >= quotas[ch]:
                defer.append(req)
            else:
                used[ch] += 1
                take.append(req)
        return take, defer

    def drain(self, cluster, state, r: int):
        """Stage this boundary's requests onto ``state``.  Returns
        ``(state', report or None)``; the report is the soak log's
        ``ingress_drain`` entry."""
        cfg = cluster.cfg
        if state.ingress == ():
            raise ValueError(
                "IngressFeed needs the ingress lane compiled in — "
                "Config(ingress=IngressConfig(enabled=True))")
        if r in self._recorded:
            # the journaled batch is the contract: re-inject it, leave the
            # ring alone
            take, deferred, replayed = self._recorded[r], [], True
        else:
            if self.ring is None:
                return state, None
            batch = self.ring.begin_drain()
            if not batch:
                return state, None
            take, deferred = self._select(cfg, batch, r,
                                          self._quotas(cfg, state))
            self.ring.defer(deferred)
            replayed = False
            if take:
                # recorded before staging: a crash in the next chunk
                # replays this batch
                self._recorded[r] = list(take)
                if self._journal is not None:
                    self._journal.append(r, take)
        if not take and not deferred:
            return state, None
        shed = invalid = 0
        if take:
            state, shed, invalid = stage(cfg, state, take, r)
        return state, {"round": int(r),
                       "staged": len(take) - shed - invalid,
                       "shed_buffer_full": shed,
                       "shed_invalid": invalid,
                       "deferred": len(deferred),
                       "replayed": replayed}


def stage(cfg, state, reqs, r: int):
    """Scatter ``reqs`` into the per-node buffer, FIFO per row into free
    slots: one host read of the occupancy, one copy to the card, four
    scatters.  A request whose row is full sheds (the later offered go
    first) into ``shed_pend``; a malformed one (``src`` or ``dst``
    outside the id space) sheds too but counts apart.  Release rounds
    already past clamp to ``r``.  Returns ``(state', n_shed_buffer_full,
    n_shed_invalid)``."""
    gs = state.ingress
    n, S = gs.release.shape
    C = cfg.n_channels
    occ = gs.release.cpu().numpy() >= 0
    free: dict = {}
    cols: list[tuple] = []
    shed = invalid = 0
    shed_ch = np.zeros(C, np.int32)
    for req in reqs:
        req = Request(*req)
        src, dst = int(req.src), int(req.dst)
        ch = min(max(int(req.channel), 0), C - 1)
        if not 0 <= src < n or not 0 <= dst < n:
            invalid += 1
            shed_ch[ch] += 1
            continue
        if src not in free:
            free[src] = [s for s in range(S) if not occ[src, s]]
        if not free[src]:
            shed += 1
            shed_ch[ch] += 1
            continue
        cols.append((src, free[src].pop(0), dst, ch, int(req.payload),
                     max(int(req.rnd), int(r))))
    if cols:
        # rows, slots, dst, channel, payload, release: one copy
        vals = torch.as_tensor(np.asarray(cols, np.int32).T,
                               device=gs.release.device)
        idx = (vals[0].long(), vals[1].long())

        def put(plane, v):
            return plane.index_put(idx, v)

        gs = gs._replace(dst=put(gs.dst, vals[2]),
                         channel=put(gs.channel, vals[3]),
                         payload=put(gs.payload, vals[4]),
                         release=put(gs.release, vals[5]))
    if shed or invalid:
        gs = gs._replace(shed_pend=gs.shed_pend + torch.as_tensor(
            shed_ch, device=gs.shed_pend.device))
    return state._replace(ingress=gs), shed, invalid
