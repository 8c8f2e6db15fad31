"""Configuration: own copy of ``partisan_tpu/config.py``'s ``Config``.

The fields are the reference's, by name and default, for everything this
slice reads or refuses, so bench.py's ``Config(...)`` call builds the
same configuration here.  The port runs the full-mesh, HyParView,
SCAMP v1/v2, static and client-server managers on the plane-major
wire, with groups or dense partitions, the send-path delay keys, every
lane of the delivery layer (acked, causal broadcast, point-to-point
causal), the channel-capacity stage, the metrics, latency (with its
flight ring), provenance and health planes and the three in-round
controllers (``ControlConfig``).  Every option the port does not carry
raises ``NotImplementedError`` at construction instead of being
silently ignored.  ``superstep`` is a loop fold with no effect on
results, so it is accepted.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from partisan_tpu_torch import types as T

DEFAULT_CHANNEL = "default"
MEMBERSHIP_CHANNEL = "partisan_membership"
RPC_CHANNEL = "rpc"
BROADCAST_CHANNEL = "broadcast"


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """A named logical link (the reference's ``channel_opts()``)."""

    name: str = DEFAULT_CHANNEL
    parallelism: int = 1
    monotonic: bool = False
    compression: bool = False


DEFAULT_CHANNELS = (
    ChannelSpec(DEFAULT_CHANNEL),
    ChannelSpec(MEMBERSHIP_CHANNEL, monotonic=True),
    ChannelSpec(RPC_CHANNEL),
    ChannelSpec(BROADCAST_CHANNEL),
)


@dataclasses.dataclass(frozen=True)
class HyParViewConfig:
    """HyParView protocol parameters (include/partisan.hrl:204-217)."""

    active_max: int = 6
    active_min: int = 3
    passive_max: int = 30
    arwl: int = 6
    prwl: int = 6
    shuffle_interval_ms: int = 10_000
    shuffle_k_active: int = 3
    shuffle_k_passive: int = 4
    random_promotion_interval_ms: int = 5_000
    xbot: bool = False
    heartbeat: bool = True
    heartbeat_every_ms: int = 10_000
    isolation_window_ms: int = 40_000
    seed_count: int = 8
    auto_rejoin: bool = True


@dataclasses.dataclass(frozen=True)
class PlumtreeConfig:
    """Plumtree broadcast-layer capacities."""

    push_slots: int = 4
    lazy_cap: int = 8
    aae: bool = True
    exchange_limit: int = 1


@dataclasses.dataclass(frozen=True)
class ScampConfig:
    """SCAMP parameters (include/partisan.hrl:240-241)."""

    c: int = 5                    # extra subscription copies on join
    message_window: int = 10      # missed-ping isolation window (v2)
    partial_max: int = 64         # capacity of partial (out) view arrays
    in_max: int = 64              # capacity of in-view arrays (v2)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """In-round feedback controllers (``control.py``), each off by
    default and each reading one plane:

    - ``fanout``: the Plumtree eager-fanout governor (needs
      ``provenance``) steps a per-round eager-link budget between
      ``fanout_min`` and the overlay width off the redundancy ring;
    - ``backpressure``: per-channel stale-shed thresholds in the
      channel-capacity outbox (needs ``latency`` and
      ``channel_capacity``), driven by each channel's delivered-age
      high-water mark;
    - ``healing``: HyParView's shuffle/promotion cadences and isolation
      window divided by ``2**heal_boost`` while the health digest shows
      a degraded overlay (needs ``health``).
    """

    fanout: bool = False
    backpressure: bool = False
    healing: bool = False
    ring: int = 64               # decision-ring rounds kept per controller
    fanout_min: int = 2          # eager-link budget floor
    fanout_every: int = 8        # evaluation window in rounds
    fanout_hi_pct: int = 40      # demote: window dup*100 >= hi*gossip
    fanout_lo_pct: int = 10      # promote: window dup*100 <= lo*gossip
    fanout_gossip_min: int = 8   # quieter windows hold the budget
    graft_hi_pct: int = 25       # promote: grafts*100 >= this*gossip
    age_hi: int = 4              # delivered-age HWM raising the pressure
    age_lo: int = 1              # ... at or below this it decays
    press_max: int = 4           # pressure ceiling
    heal_boost: int = 2          # cadence right-shift while degraded
    heal_hold: int = 2           # healthy snapshots before relaxing

    @property
    def any(self) -> bool:
        return self.fanout or self.backpressure or self.healing


MANAGERS = ("fullmesh", "hyparview", "scamp_v1", "scamp_v2",
            "client_server", "static")

# Options whose planes or paths the port does not carry, with the value
# that keeps them off.  Setting any other value raises.
_OFF = {"elastic": False, "salt_operand": False, "plane_major": True}
# Parameter blocks of unported subsystems (distance, traffic, ingress,
# watchdog): only their absence is accepted.
_ABSENT = ("distance", "traffic", "ingress", "watchdog")


@dataclasses.dataclass(frozen=True)
class Config:
    """Cluster-simulation configuration (the reference's fields)."""

    n_nodes: int = 16
    peer_service_manager: str = "fullmesh"
    membership_strategy: str = "full"
    cs_servers: int = 1
    round_ms: int = 1_000
    periodic_interval_ms: int = 10_000
    retransmit_interval_ms: int = 1_000
    lazy_tick_ms: int = 1_000
    exchange_tick_ms: int = 10_000
    timer_stagger: bool = True
    egress_delay_ms: int = 0
    ingress_delay_ms: int = 0
    delay_buf_cap: int = 0
    causal_labels: tuple = ()     # one causal broadcast lane per label
    ack_cap: int = 0              # outstanding acked sends per node
    causal_buf_cap: int = 8       # undelivered causal records buffered
    causal_emit_cap: int = 4      # causal sends per node per round
    causal_hist_cap: int = 8      # sender-side re-emission history
    causal_deliver_cap: int = 16  # causal deliveries per node per round
    causal_p2p_labels: tuple = ()  # one point-to-point causal lane each
    p2p_dst_cap: int = 64         # sender-side per-destination seq table
    p2p_src_cap: int = 64         # receiver-side per-sender seq table
    p2p_buf_cap: int = 8          # out-of-order arrivals buffered
    p2p_hist_cap: int = 8         # sender replay ring (unacked store)
    p2p_emit_cap: int = 4         # p2p causal sends per node per round
    channels: tuple = DEFAULT_CHANNELS
    hyparview: HyParViewConfig = HyParViewConfig()
    scamp: ScampConfig = ScampConfig()
    plumtree: PlumtreeConfig = PlumtreeConfig()
    distance: Any = None
    control: ControlConfig = ControlConfig()
    traffic: Any = None
    ingress: Any = None
    watchdog: Any = None
    inbox_cap: int = 32
    emit_cap: int = 16
    emit_compact: int = 0
    msg_words: int = 12
    max_broadcasts: int = 64
    n_actors: int = 64            # vclock width of the causal lanes
    seed: int = 0
    superstep: int = 1
    channel_capacity: bool = False  # enforce ChannelSpec.parallelism
    lane_rate: int = 1            # msgs per lane per (edge, channel) per
    #                               round with channel_capacity on
    outbox_cap: int = 32          # deferred sends carried per node
    width_operand: bool = False
    elastic: bool = False
    salt_operand: bool = False
    partition_mode: str = "auto"
    monotonic_shed: bool = True
    metrics: bool = False
    metrics_ring: int = 128
    latency: bool = False
    flight_rounds: int = 0
    provenance: bool = False
    provenance_ring: int = 128
    health: int = 0
    health_ring: int = 64
    plane_major: bool = True

    def __post_init__(self) -> None:
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        names = [c.name for c in self.channels]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate channel names: {names}")
        if DEFAULT_CHANNEL not in names:
            raise ValueError("channels must include the default channel")
        for c in self.channels:
            if c.parallelism < 1:
                raise ValueError(
                    f"channel {c.name}: parallelism must be >= 1")
        if self.msg_words < 8:
            raise ValueError("msg_words must be >= 8 (header is 8 words)")
        if self.superstep < 1:
            raise ValueError(
                f"superstep must be >= 1, got {self.superstep}")
        if self.partition_mode not in ("auto", "dense", "groups"):
            raise ValueError(
                f"partition_mode {self.partition_mode!r} not in "
                f"('auto', 'dense', 'groups')")
        if self.metrics_ring < 1:
            raise ValueError(
                f"metrics_ring must be >= 1, got {self.metrics_ring}")
        if self.flight_rounds < 0:
            raise ValueError(
                f"flight_rounds must be >= 0, got {self.flight_rounds}")
        if self.provenance_ring < 1:
            raise ValueError(
                f"provenance_ring must be >= 1, got {self.provenance_ring}")
        if self.health < 0:
            raise ValueError(
                f"health must be >= 0 (a snapshot cadence in rounds; "
                f"0 = off), got {self.health}")
        if self.health_ring < 1:
            raise ValueError(
                f"health_ring must be >= 1, got {self.health_ring}")
        # each controller reads one plane: without it the loop would
        # silently read nothing
        if self.control.fanout and not self.provenance:
            raise ValueError(
                "control.fanout reads the provenance plane's redundancy "
                "ring — set Config(provenance=True)")
        if self.control.backpressure and not self.latency:
            raise ValueError(
                "control.backpressure reads delivery ages off the "
                "latency plane's birth word — set Config(latency=True)")
        if self.control.backpressure and not self.channel_capacity:
            raise ValueError(
                "control.backpressure drives shed thresholds in the "
                "channel-capacity outbox — set "
                "Config(channel_capacity=True)")
        if self.control.healing and self.health <= 0:
            raise ValueError(
                "control.healing keys repair cadences off the health "
                "digest — set Config(health=K)")
        if self.control.any:
            c = self.control
            if c.ring < 1:
                raise ValueError(f"control.ring must be >= 1, got {c.ring}")
            if c.fanout_min < 1:
                raise ValueError("control.fanout_min must be >= 1")
            if c.press_max < 1:
                raise ValueError("control.press_max must be >= 1")
            if c.heal_boost < 0:
                raise ValueError("control.heal_boost must be >= 0")
            if not 0 <= c.fanout_lo_pct < c.fanout_hi_pct:
                raise ValueError(
                    "control fanout bands need "
                    "0 <= fanout_lo_pct < fanout_hi_pct")
            if c.fanout_every < 1:
                raise ValueError("control.fanout_every must be >= 1")
            if c.age_lo >= c.age_hi:
                raise ValueError(
                    "control backpressure bands need age_lo < age_hi")
        for key, off in _OFF.items():
            if getattr(self, key) != off:
                raise NotImplementedError(
                    f"Config.{key}={getattr(self, key)!r} is not ported "
                    f"to partisan_tpu_torch yet (only {off!r})")
        for key in _ABSENT:
            if getattr(self, key) is not None:
                raise NotImplementedError(
                    f"Config.{key} is not ported to partisan_tpu_torch yet")
        if self.peer_service_manager not in MANAGERS:
            raise NotImplementedError(
                f"peer_service_manager={self.peer_service_manager!r}: "
                f"only {MANAGERS} are ported")
        if self.hyparview.xbot:
            raise NotImplementedError("HyParView X-BOT is not ported yet")
        if not self.channel_capacity:
            # parallelism > 1 without capacity enforcement is advisory
            # only (the reference warns the same way)
            loud = [c.name for c in self.channels if c.parallelism > 1]
            if loud:
                warnings.warn(
                    f"channels {loud} declare parallelism > 1 but "
                    f"channel_capacity enforcement is off — parallelism "
                    f"is advisory (set channel_capacity=True to enforce "
                    f"per-lane throughput)", stacklevel=2)

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def wire_words(self) -> int:
        """Words per queued wire record: ``msg_words``, plus the
        provenance pair (emitter gid, sender hop) when ``provenance`` is
        on, plus the latency plane's birth round, always last, when
        ``latency`` is on.  Managers and models build ``msg_words``-wide
        records; the round appends the trailing words."""
        w = self.msg_words
        if self.provenance:
            w += 2
        if self.latency:
            w += 1
        return w

    @property
    def wire_dtypes(self) -> tuple:
        """Storage dtype per wire word (the bytes-first packing map,
        trailing words included: the hop word is int16)."""
        return tuple(T.wire_dtype(i, msg_words=self.msg_words,
                                  provenance=self.provenance)
                     for i in range(self.wire_words))

    @property
    def wire_layout(self) -> tuple:
        """What ``exchange.empty_inbox`` needs: the per-word dtypes."""
        return self.wire_dtypes

    def channel_id(self, name: str) -> int:
        for i, c in enumerate(self.channels):
            if c.name == name:
                return i
        raise KeyError(f"unknown channel {name!r}")

    def causal_lane_id(self, label: str) -> int:
        """Lane index for W_LANE: broadcast lanes first, then p2p lanes
        (one shared index space)."""
        if label in self.causal_labels:
            return self.causal_labels.index(label)
        if label in self.causal_p2p_labels:
            return len(self.causal_labels) + \
                self.causal_p2p_labels.index(label)
        raise KeyError(
            f"unknown causal label {label!r}; have "
            f"{self.causal_labels + self.causal_p2p_labels}")

    @property
    def resolved_partition_mode(self) -> str:
        if self.partition_mode == "auto":
            return "dense" if self.n_nodes <= 2048 else "groups"
        return self.partition_mode

    def rounds(self, interval_ms: int) -> int:
        """Wall-clock cadence -> whole rounds (>= 1)."""
        return max(1, round(interval_ms / self.round_ms))

    def timer_phase(self, gids: torch.Tensor):
        """Per-node timer phase: the node id when staggered, else 0."""
        return gids if self.timer_stagger else 0

    @property
    def gossip_every(self) -> int:
        return self.rounds(self.periodic_interval_ms)

    @property
    def retransmit_every(self) -> int:
        return self.rounds(self.retransmit_interval_ms)

    @property
    def lazy_tick_every(self) -> int:
        return self.rounds(self.lazy_tick_ms)

    @property
    def exchange_tick_every(self) -> int:
        return self.rounds(self.exchange_tick_ms)

    @property
    def shuffle_every(self) -> int:
        return self.rounds(self.hyparview.shuffle_interval_ms)

    @property
    def promotion_every(self) -> int:
        return self.rounds(self.hyparview.random_promotion_interval_ms)

    @property
    def send_delay_rounds(self) -> int:
        """Total send-path hold of the egress/ingress delay keys (0 = no
        delay stage; ``interpose.config_delays`` installs it)."""
        r = 0
        if self.egress_delay_ms > 0:
            r += self.rounds(self.egress_delay_ms)
        if self.ingress_delay_ms > 0:
            r += self.rounds(self.ingress_delay_ms)
        return r

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)
