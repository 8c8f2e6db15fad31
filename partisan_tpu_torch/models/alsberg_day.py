"""Alsberg-Day primary/backup replication, plain and acked (port of
``partisan_tpu/models/alsberg_day.py``).

Clients write to the primary (global node 0, the membership head); the
primary applies the write, records it outstanding and sends COLLABORATE
to every other alive node; each backup applies it and answers
COLLAB_ACK; once every awaited backup acked, the primary answers
WRITE_OK.  A non-primary receiving a write answers NOT_PRIMARY.  The
acked variant flags its sends ``F_ACK_REQUIRED``, so the ack lane
retransmits them.  Collaborations are generation-tagged (aux = gen *
GEN_BASE + client): a backup applies only generations at or above its
newest, and the primary counts only current-generation acks.

Same-round writes to one key: the primary keeps one winner, the last
inbox slot addressing the key (picked explicitly, so every device
agrees); each losing client is acknowledged at once with its own value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops
from partisan_tpu_torch.ops import select
from partisan_tpu_torch.ops.scatter import (fold_true, last_writer,
                                           set_at, take_last)

# APP payload layout: [op, key, value, aux]
OP_WRITE = 30        # client -> primary
OP_COLLABORATE = 31  # primary -> backups
OP_COLLAB_ACK = 32   # backup -> primary
OP_WRITE_OK = 33     # primary -> client
OP_NOT_PRIMARY = 34  # error reply

PRIMARY = 0          # membership head

# aux = gen * GEN_BASE + client: client ids are bounded by GEN_BASE
GEN_BASE = 1 << 12


class AlsbergDayState(NamedTuple):
    store: torch.Tensor        # int32[n, K] — replicated registers
    written: torch.Tensor      # bool[n, K] — register has been written
    # client side
    req_pending: torch.Tensor  # bool[n, K] — writes queued to send
    req_value: torch.Tensor    # int32[n, K]
    req_ok: torch.Tensor       # bool[n, K] — ok received
    # primary side: outstanding collaborations
    out_client: torch.Tensor   # int32[n, K] — requesting client (-1 idle)
    out_acks: torch.Tensor     # bool[n, K, P] — backup acks collected
    out_mask: torch.Tensor     # bool[n, K, P] — backups awaited
    gen: torch.Tensor          # int32[n, K] — collaboration generation
    b_gen: torch.Tensor        # int32[n, K] — newest generation applied


class AlsbergDay:
    def __init__(self, acked: bool = False, keys: int = 8) -> None:
        self.acked = acked
        self.keys = keys
        self.name = "alsberg_day_acked" if acked else "alsberg_day"

    def init(self, cfg, comm) -> AlsbergDayState:
        if comm.n_global > GEN_BASE:
            raise ValueError(
                f"alsberg_day packs client ids into {GEN_BASE} slots "
                f"(aux = gen*GEN_BASE + client); n_nodes="
                f"{comm.n_global} exceeds that")
        n, k, p, dev = comm.n_local, self.keys, comm.n_global, comm.device

        def z(dt, shape=(n, k)):
            return torch.zeros(shape, dtype=dt, device=dev)

        return AlsbergDayState(
            store=z(torch.int32), written=z(torch.bool),
            req_pending=z(torch.bool), req_value=z(torch.int32),
            req_ok=z(torch.bool),
            out_client=torch.full((n, k), -1, dtype=torch.int32, device=dev),
            out_acks=z(torch.bool, (n, k, p)),
            out_mask=z(torch.bool, (n, k, p)),
            gen=z(torch.int32), b_gen=z(torch.int32))

    def step(self, cfg, comm, st: AlsbergDayState, ctx, nbrs):
        n, k = st.store.shape
        p = st.out_acks.shape[-1]
        gids = comm.local_ids()
        dev = gids.device
        alive = ctx.alive
        live = alive[:, None]
        flags = T.F_ACK_REQUIRED if self.acked else 0

        inb = ctx.inbox.data
        cap = inb[T.W_KIND].shape[1]
        is_app = inb[T.W_KIND] == T.MsgKind.APP
        op = torch.where(is_app & live, inb[T.P0], 0)
        key = torch.where(is_app, inb[T.P1], 0).clamp(0, k - 1)
        key64 = key.to(torch.int64)
        val, aux, src = inb[T.P2], inb[T.P3], inb[T.W_SRC]
        r2 = torch.arange(n, device=dev)[:, None].expand(n, cap)
        is_primary = gids == PRIMARY

        def at_key(x, m=None):
            """x[n, K] read at each message's key (key 0 where ``m`` is
            False)."""
            idx = key64 if m is None else torch.where(m, key64, 0)
            return torch.gather(x, 1, idx)

        # ---- apply writes (primary) and collaborations (backups) ------
        # a backup applies only generations >= its newest (a retransmitted
        # stale COLLABORATE must not revert a newer value)
        m_write = (op == OP_WRITE) & is_primary[:, None]
        m_collab = op == OP_COLLABORATE
        msg_gen = aux // GEN_BASE
        collab_fresh = m_collab & (msg_gen >= at_key(st.b_gen, m_collab))
        m_apply = m_write | collab_fresh
        win_apply = last_writer(key, m_apply, k)
        store = take_last(st.store, win_apply, val)
        written = st.written | (win_apply >= 0)
        b_gen = torch.cat([st.b_gen, st.b_gen.new_zeros((n, 1))],
                          dim=1).scatter_reduce_(
            1, torch.where(collab_fresh, key64, k), msg_gen, "amax")[:, :k]

        # the primary records the outstanding collaboration; backups
        # awaited = every other GLOBALLY alive member
        win_write = last_writer(key, m_write, k)
        incoming = take_last(torch.full_like(st.out_client, -1), win_write,
                             src)
        incoming_val = take_last(torch.zeros_like(st.store), win_write, val)
        started = incoming >= 0
        # a re-send of the same client's outstanding write of the same
        # value is a duplicate: it neither restarts nor acks early
        dup = started & (st.out_client >= 0) \
            & (incoming == st.out_client) & (incoming_val == st.store)
        restart = started & ~dup
        # a different client's write to a busy key subsumes the
        # outstanding one, whose client is acknowledged at once
        displaced = restart & (st.out_client >= 0) \
            & (st.out_client != incoming)
        out_client = torch.where(restart, incoming, st.out_client)
        gen = st.gen + restart.to(torch.int32)
        pid = torch.arange(p, dtype=torch.int32, device=dev)
        backups = ctx.faults.alive[None, :] & (pid[None, :] != PRIMARY)
        new_mask = backups[:, None, :].expand(n, k, p)
        out_mask = torch.where(restart[..., None], new_mask, st.out_mask)
        out_acks = st.out_acks & ~restart[..., None]

        # same-round write collisions: each losing write is acknowledged
        # at once, echoing its own value
        winner = (at_key(incoming) == src) & (at_key(incoming_val) == val)
        lost = m_write & ~winner

        # collect backup acks for the CURRENT generation only
        is_ack = op == OP_COLLAB_ACK
        m_ack = is_ack & is_primary[:, None] & (msg_gen == at_key(gen, is_ack))
        out_acks = fold_true(
            out_acks, (r2, torch.where(m_ack, key64, k),
                       src.clamp(0, p - 1)), dim=1)

        # ok to the client once every awaited backup acked
        complete = (out_client >= 0) & (~out_mask | out_acks).all(dim=-1) \
            & is_primary[:, None] & live
        ok_dst = torch.where(complete, out_client, -1)
        out_client = torch.where(complete, -1, out_client)

        # client: an ok counts only for the write it is awaiting
        m_ok = (op == OP_WRITE_OK) & (val == at_key(st.req_value))
        req_ok = fold_true(st.req_ok, (r2, torch.where(m_ok, key64, k)))

        # ---- emissions ------------------------------------------------
        blocks = []
        kind = int(T.MsgKind.APP)
        kid = torch.arange(k, dtype=torch.int32, device=dev)
        # (1) client write requests, sent once (the acked variant's
        # retransmission is the ack lane's)
        fire = st.req_pending & live
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None], torch.where(fire, PRIMARY, -1),
            flags=flags, payload=(OP_WRITE, kid[None, :], st.req_value, 0)))
        req_pending = st.req_pending & ~fire

        # (2) primary COLLABORATE fan-out for collaborations (re)started
        # this round
        aux_client = torch.where(restart, gen * GEN_BASE + incoming, 0)
        col_dst = torch.where(restart[..., None] & new_mask, pid, -1)
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None, None], col_dst, flags=flags,
            payload=(OP_COLLABORATE, kid[None, :, None], store[..., None],
                     aux_client[..., None]),
        ).map(lambda w: w.reshape(n, k * p)))

        # (3) replies per inbox message: collaborate acks (fresh
        # generations only), not_primary errors, collision-loser oks
        misrouted = (op == OP_WRITE) & ~is_primary[:, None]
        rep_op = select([collab_fresh, misrouted, lost],
                        [OP_COLLAB_ACK, OP_NOT_PRIMARY, OP_WRITE_OK],
                        torch.zeros_like(op))
        rep_dst = torch.where((rep_op > 0) & live, src, -1)
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None], rep_dst, flags=flags,
            payload=(rep_op, key, val, aux)))

        # (4) primary oks: completed, and displaced by a newer write (the
        # latter reports the displaced write's value, the round-start
        # store)
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None], ok_dst, flags=flags,
            payload=(OP_WRITE_OK, kid[None, :], store, 0)))
        disp_dst = torch.where(displaced & live, st.out_client, -1)
        blocks.append(msg_ops.build(
            cfg, kind, gids[:, None], disp_dst, flags=flags,
            payload=(OP_WRITE_OK, kid[None, :], st.store, 0)))

        emitted = plane_ops.concat(blocks, dim=1)
        new = AlsbergDayState(
            store=store, written=written,
            req_pending=req_pending, req_value=st.req_value, req_ok=req_ok,
            out_client=out_client, out_acks=out_acks, out_mask=out_mask,
            gen=gen, b_gen=b_gen)
        return new, emitted

    # ---- scenario helpers --------------------------------------------
    def write(self, st: AlsbergDayState, client: int, key: int,
              value: int) -> AlsbergDayState:
        """Queue ``{write, Key, Value}`` at ``client``."""
        at = (client, key)
        return st._replace(req_pending=set_at(st.req_pending, at, True),
                           req_value=set_at(st.req_value, at, value),
                           req_ok=set_at(st.req_ok, at, False))

    @staticmethod
    def replicated(st: AlsbergDayState, key: int,
                   alive: torch.Tensor) -> torch.Tensor:
        """True iff every alive node stores the same written value."""
        have = st.written[:, key] & alive
        vals = torch.where(have, st.store[:, key], -1)
        agree = (vals == vals.max()) | ~have
        return (st.written[:, key] | ~alive).all() & agree.all()

    @staticmethod
    def acked_ok(st: AlsbergDayState, client: int, key: int
                 ) -> torch.Tensor:
        return st.req_ok[client, key]
