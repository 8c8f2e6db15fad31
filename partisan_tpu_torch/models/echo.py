"""Echo/latency benchmark workload (port of
``partisan_tpu/models/echo.py``; the ``performance_test`` harness).

Two nodes; ``concurrency`` logical sender processes on the client each
ping-pong ``num_messages`` payloads against the server (send, wait for
the echo, send the next), each sender on its own partition key, so the
channel's parallelism lanes bound how many pings travel per round.
Payload size and link latency shape the virtual clock, not the tensor
shapes (``scenarios.config6_echo``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from partisan_tpu_torch import types as T
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops import plane as plane_ops

CLIENT, SERVER = 0, 1


class EchoState(NamedTuple):
    to_send: torch.Tensor   # int32[n, C] — messages left per sender
    awaiting: torch.Tensor  # bool[n, C] — a ping is in flight
    echoed: torch.Tensor    # int32[n, C] — echoes received per sender


class Echo:
    name = "echo"

    def __init__(self, concurrency: int, num_messages: int) -> None:
        self.concurrency = concurrency
        self.num_messages = num_messages

    def init(self, cfg, comm) -> EchoState:
        n, C, dev = comm.n_local, self.concurrency, comm.device
        to_send = torch.zeros((n, C), dtype=torch.int32, device=dev)
        to_send[CLIENT] = self.num_messages
        return EchoState(
            to_send=to_send,
            awaiting=torch.zeros((n, C), dtype=torch.bool, device=dev),
            echoed=torch.zeros((n, C), dtype=torch.int32, device=dev))

    def step(self, cfg, comm, state: EchoState, ctx, nbrs):
        gids = comm.local_ids()
        n, C = state.to_send.shape
        inb = ctx.inbox.data
        kind = inb[T.W_KIND]
        sender = inb[T.P0]                                  # sender index
        is_ping = (kind == T.MsgKind.APP) & (inb[T.P1] == 0)
        is_echo = (kind == T.MsgKind.APP) & (inb[T.P1] == 1)

        # Server: echo every ping back to its origin, same lane.
        reply_dst = torch.where(is_ping & (gids == SERVER)[:, None],
                                inb[T.W_SRC], -1)
        replies = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None], reply_dst,
            lane=sender, payload=(sender, torch.ones_like(sender)))

        # Client: an echo frees its sender process for the next ping.
        ar = torch.arange(C, device=gids.device)
        echo_hit = (is_echo & (gids == CLIENT)[:, None])[:, :, None] \
            & (sender[:, :, None] == ar[None, None, :])
        got = echo_hit.any(dim=1)                             # [n, C]
        awaiting = state.awaiting & ~got
        # Fire: senders not awaiting with messages left.
        fire = (gids == CLIENT)[:, None] & ~awaiting & (state.to_send > 0)
        lanes = ar.to(torch.int32)[None, :].expand(n, C)
        pings = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None],
            torch.where(fire, SERVER, -1),
            lane=lanes, payload=(lanes, torch.zeros_like(lanes)))
        return EchoState(
            to_send=state.to_send - fire.to(torch.int32),
            awaiting=awaiting | fire,
            echoed=state.echoed + got.to(torch.int32),
        ), plane_ops.concat([replies, pings], dim=1)

    def done(self, state: EchoState) -> bool:
        return bool((state.to_send[CLIENT] == 0).all()
                    & (~state.awaiting[CLIENT]).all())
