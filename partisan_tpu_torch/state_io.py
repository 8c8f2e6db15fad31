"""Carry cluster states between the JAX reference and the port.

``state_from_numpy`` takes a reference ``ClusterState`` after
``jax.device_get`` — numpy leaves, NamedTuples preserved, ``Planes``
with ``.ws``, dicts and tuples for interposition states — and builds
the port's state on a device.  It reads the tree by duck typing
(``_fields``, ``.ws``) and the NamedTuple class names, never by
importing JAX.  ``state_to_numpy`` is the inverse: the port's tree with
numpy leaves.  ``flatten`` lists leaves in pytree order (fields in
order, planes in word order, dict keys sorted, ``()`` contributing
nothing), the order the reference's ``jax.tree_util`` flattening uses.

The reference's uint32 OR-set views and causal-lane vector clocks are
int64 tensors in the port (``ops/orset.py``, ``ops/vclock.py``): they
cross as uint32 numpy leaves both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from partisan_tpu_torch import channels, cluster, control, delivery
from partisan_tpu_torch import device as device_mod
from partisan_tpu_torch import faults, health, latency, metrics, provenance
from partisan_tpu_torch.managers import (client_server, fullmesh,
                                         hyparview, scamp, static)
from partisan_tpu_torch.models import (alsberg_day, anti_entropy,
                                       causal_chat, commit, direct_mail,
                                       echo, p2p_chat, paxos, plumtree,
                                       rumor_mongering)
from partisan_tpu_torch.ops import exchange
from partisan_tpu_torch.ops.plane import Planes

_TYPES = {cls.__name__: cls for cls in (
    cluster.ClusterState, cluster.Stats, cluster.TraceRound,
    faults.FaultState, exchange.Inbox, hyparview.HyParViewState,
    plumtree.PlumtreeState, fullmesh.FullMeshState,
    direct_mail.DirectMailState, delivery.DeliveryState,
    delivery.AckState, scamp.ScampState, static.StaticState,
    client_server.ClientServerState, anti_entropy.AntiEntropyState,
    rumor_mongering.RumorState, health.HealthState, delivery.CausalLane,
    delivery.P2PLane, channels.OutboxState, p2p_chat.P2PChatState,
    causal_chat.ChatState, echo.EchoState, paxos.PaxosState,
    commit.CommitState, alsberg_day.AlsbergDayState,
    metrics.MetricsState, latency.LatencyState, latency.FlightState,
    provenance.ProvenanceState, control.ControlState, control.FanoutState,
    control.BackpressureState, control.HealingState)}

# (NamedTuple, field) leaves the reference keeps as uint32 and the port
# holds in int64.
_UINT32_HELD = {("FullMeshState", "view"), ("CausalLane", "clock")}


def state_from_numpy(tree, device=None):
    """A reference state (numpy leaves) -> the port's state on ``device``
    (default: the card)."""
    dev = device_mod.resolve(device)

    def leaf(x):
        a = np.array(x)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=dev)

    def conv(x):
        if hasattr(x, "_fields"):
            cls = _TYPES.get(type(x).__name__)
            if cls is None:
                raise TypeError(f"no port type for {type(x).__name__}")
            if tuple(cls._fields) != tuple(x._fields):
                raise TypeError(f"{type(x).__name__}: fields differ "
                                f"({x._fields} vs {cls._fields})")
            return cls(*(conv(v) for v in x))
        if hasattr(x, "ws") or isinstance(x, Planes):
            return Planes(conv(w) for w in getattr(x, "ws", x))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return leaf(x)

    return conv(tree)


def state_to_numpy(state):
    """The port's state -> the same tree with numpy leaves."""
    if isinstance(state, Planes):
        return Planes(state_to_numpy(w) for w in state)
    if hasattr(state, "_fields"):
        name = type(state).__name__
        return type(state)(*(
            state_to_numpy(v).astype(np.uint32)
            if (name, f) in _UINT32_HELD else state_to_numpy(v)
            for f, v in zip(state._fields, state)))
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(state_to_numpy(v) for v in state)
    return state.detach().cpu().numpy()


def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] in pytree order."""
    def sub(name):
        return f"{prefix}.{name}" if prefix else str(name)

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], sub(k))]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [x for name, v in zip(names, tree)
                for x in flatten(v, sub(name))]
    return [(prefix, tree)]
