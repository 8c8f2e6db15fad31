"""Point-to-point causal chat workload (port of
``partisan_tpu/models/p2p_chat.py``; config 5's causal traffic).

Drives the delivery layer's p2p causal lane: any node sends
causally-ordered messages to chosen destinations, with per-(sender,
destination) FIFO and exactly-once delivery.  Scripted sends fire at
configured rounds; every delivery is logged as ``sender * K + seq`` so
the host checks can assert per-edge FIFO.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops


class P2PChatState(NamedTuple):
    log: torch.Tensor       # int32[n, L] — delivered (sender * K + seq)
    log_len: torch.Tensor   # int32[n]
    seq: torch.Tensor       # int32[n]
    send_at: torch.Tensor   # int32[n, S]
    send_dst: torch.Tensor  # int32[n, S]


def log_deliveries(inb, log, log_len, K: int):
    """Append this round's causal APP deliveries to the per-node logs,
    in inbox order: (log', log_len')."""
    n, L = log.shape
    is_chat = (inb[T.W_KIND] == T.MsgKind.APP) \
        & ((inb[T.W_FLAGS] & T.F_CAUSAL) != 0)
    tok = torch.where(is_chat, inb[T.W_SRC] * K + inb[T.P0], 0)
    rank = torch.cumsum(is_chat, dim=1) - 1
    slot = torch.where(is_chat, log_len[:, None] + rank, L).clamp(max=L)
    pad = torch.cat([log, log.new_zeros((n, 1))], dim=1)
    log = pad.scatter(1, slot.to(torch.int64), tok.to(log.dtype))[:, :L]
    return log, log_len + is_chat.sum(dim=1, dtype=torch.int32)


def log_lists(state) -> list[list[int]]:
    """Each node's delivery log as a host list."""
    log = state.log.cpu().numpy()
    lens = state.log_len.cpu().numpy()
    return [list(map(int, log[i, :lens[i]])) for i in range(log.shape[0])]


class P2PChat:
    """Scripted p2p-causal senders + delivery log."""

    name = "p2p_chat"
    LOG = 32
    SLOTS = 8
    K = 1000

    def __init__(self, label: str = "chat") -> None:
        self.label = label

    def init(self, cfg, comm) -> P2PChatState:
        n, dev = comm.n_local, comm.device

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.int32, device=dev)

        return P2PChatState(log=full((n, self.LOG), 0),
                            log_len=full((n,), 0), seq=full((n,), 1),
                            send_at=full((n, self.SLOTS), -1),
                            send_dst=full((n, self.SLOTS), -1))

    def step(self, cfg, comm, state: P2PChatState, ctx, nbrs):
        gids = comm.local_ids()
        log, log_len = log_deliveries(ctx.inbox.data, state.log,
                                      state.log_len, self.K)
        fire = (state.send_at == ctx.rnd) & ctx.alive[:, None]   # [n, S]
        dst = torch.where(fire, state.send_dst, -1)
        srank = torch.cumsum(fire, dim=1)
        emitted = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None], dst, flags=T.F_CAUSAL,
            lane=cfg.causal_lane_id(self.label),
            payload=(state.seq[:, None] + srank - 1,))
        seq = state.seq + fire.sum(dim=1, dtype=torch.int32)
        return state._replace(log=log, log_len=log_len, seq=seq), emitted

    # ---- scripting ----------------------------------------------------
    def schedule(self, state: P2PChatState, node: int, rnd: int,
                 dst: int, now: int = 0) -> P2PChatState:
        """Schedule one send; slots whose round already passed (< now)
        are reusable."""
        row = state.send_at[node].cpu().numpy()
        free_mask = row < now if now > 0 else row < 0
        assert free_mask.any(), f"node {node}: all {self.SLOTS} slots used"
        free = int(np.argmax(free_mask))
        send_at, send_dst = state.send_at.clone(), state.send_dst.clone()
        send_at[node, free] = rnd
        send_dst[node, free] = dst
        return state._replace(send_at=send_at, send_dst=send_dst)

    def schedule_many(self, state: P2PChatState, nodes, rnds, dsts,
                      slots=None) -> P2PChatState:
        """Batched scripting (one scatter).  ``slots[i]`` defaults to the
        i-th use of the node in this batch."""
        nodes = np.asarray(nodes, np.int64)
        rnds = np.asarray(rnds, np.int32)
        dsts = np.asarray(dsts, np.int32)
        if slots is None:
            seen: dict[int, int] = {}
            slots = np.empty_like(nodes)
            for i, nd in enumerate(nodes):
                slots[i] = seen.get(int(nd), 0)
                seen[int(nd)] = slots[i] + 1
        slots = np.asarray(slots, np.int64)
        if (slots >= self.SLOTS).any():
            raise ValueError(f"more than {self.SLOTS} sends per node")
        dev = state.send_at.device
        idx = (torch.as_tensor(nodes, device=dev),
               torch.as_tensor(slots, device=dev))
        send_at, send_dst = state.send_at.clone(), state.send_dst.clone()
        send_at[idx] = torch.as_tensor(rnds, device=dev)
        send_dst[idx] = torch.as_tensor(dsts, device=dev)
        return state._replace(send_at=send_at, send_dst=send_dst)

    # ---- host-side checks ---------------------------------------------
    @classmethod
    def logs(cls, state: P2PChatState) -> list[list[int]]:
        return log_lists(state)

    @classmethod
    def edge_fifo_ok(cls, log: list[int]) -> bool:
        """Every sender's seqs at this receiver are 1, 2, 3, ... in
        order."""
        per_src: dict[int, list[int]] = {}
        for t in log:
            per_src.setdefault(t // cls.K, []).append(t % cls.K)
        return all(seqs == list(range(1, len(seqs) + 1))
                   for seqs in per_src.values())
