"""Wire record layout: header word indices, message kinds, storage dtypes.

Own copy of ``partisan_tpu/types.py`` (the port imports nothing of the
JAX package).  A message is a fixed-width record of ``msg_words`` int32
words: an 8-word header, then protocol payload words.  In the
plane-major layout each word is its own tensor, stored at the narrowest
dtype its documented value range permits, and widened to int32 only at
the plane->wire interleave.
"""

from __future__ import annotations

import enum

import torch

HDR_WORDS = 8

W_KIND = 0      # MsgKind — 0 (NONE) marks an empty slot
W_SRC = 1       # sender node id
W_DST = 2       # destination node id (routing key)
W_CHANNEL = 3   # channel id (index into Config.channels)
W_TTL = 4       # remaining hops for random walks / tree relay
W_CLOCK = 5     # per-sender monotonic message clock
W_LANE = 6      # parallelism lane
W_FLAGS = 7     # bitfield

P0, P1, P2, P3 = HDR_WORDS, HDR_WORDS + 1, HDR_WORDS + 2, HDR_WORDS + 3


# W_FLAGS bits
F_ACK_REQUIRED = 1 << 0     # {ack, true} forward option
F_RETRANSMISSION = 1 << 1   # re-sent by the retransmit timer
F_CAUSAL = 1 << 2           # routed through a causality lane
F_P2P_STAMPED = 1 << 3      # point-to-point causal record, already
#                             stamped with its per-edge seq and epoch
F_DELAY_RELEASED = 1 << 4   # released by the egress/ingress delay stage


class MsgKind(enum.IntEnum):
    """Every message kind of the reference (values identical), so a trace
    renders the same kind names on both sides."""

    NONE = 0
    PING = 1
    PONG = 2
    ACK = 3
    P2P_ACK = 4
    HPV_JOIN = 10
    HPV_FORWARD_JOIN = 11
    HPV_NEIGHBOR = 12
    HPV_NEIGHBOR_ACCEPTED = 13
    HPV_NEIGHBOR_REJECTED = 14
    HPV_DISCONNECT = 15
    HPV_SHUFFLE = 16
    HPV_SHUFFLE_REPLY = 17
    HPV_XBOT_OPT = 18
    HPV_XBOT_OPT_REPLY = 19
    SCAMP_SUBSCRIPTION = 20
    SCAMP_UNSUBSCRIBE = 21
    SCAMP_KEEP = 22
    SCAMP_REPLACE = 23
    HPV_XBOT_REPLACE = 24
    HPV_XBOT_SWITCH = 25
    HPV_XBOT_SWITCH_REPLY = 26
    HPV_XBOT_REPLACE_REPLY = 27
    PT_GOSSIP = 30
    PT_IHAVE = 31
    PT_GRAFT = 32
    PT_PRUNE = 33
    PT_IHAVE_ACK = 34
    APP = 40
    RPC_CALL = 41
    RPC_RESPONSE = 42
    GEN_CALL = 43
    GEN_REPLY = 44
    GEN_CAST = 45


# kind/channel/flags fit int8, walk and relay TTLs int16; ids, clocks,
# lanes and payload words stay int32.
NARROW_WIRE_DTYPES = {
    W_KIND: torch.int8,
    W_CHANNEL: torch.int8,
    W_TTL: torch.int16,
    W_FLAGS: torch.int8,
}


def wire_dtype(i: int) -> torch.dtype:
    """Storage dtype of wire word ``i``."""
    return NARROW_WIRE_DTYPES.get(i, torch.int32)
