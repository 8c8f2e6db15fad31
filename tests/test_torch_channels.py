"""The channel-capacity stage and the Echo model in the port against the
JAX reference on the CPU: ``channels.throttle`` on seeded random
emission stacks (a non-empty outbox, parallelism 1/2/4, lane_rate 1/3,
an outbox small enough to overflow), the Cluster setups of
tests/test_channels.py (the Flood probe under parallelism 1, 4 and 8,
outbox overflow, FIFO across the outbox), and one Echo run at n=2 with
concurrency 4.  Every output and every state leaf must be bit-identical
(after every round for the Cluster runs), tolerance 0."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu import channels as jchannels
from partisan_tpu.cluster import Cluster as JCluster
from partisan_tpu.comm import LocalComm as JComm
from partisan_tpu.config import ChannelSpec as JChannelSpec
from partisan_tpu.config import Config as JConfig
from partisan_tpu.models.echo import Echo as JEcho
from partisan_tpu.ops import plane as jplane
from partisan_tpu_torch import channels as tchannels
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch import state_io
from partisan_tpu_torch import types as T
from partisan_tpu_torch.cluster import Cluster as TCluster
from partisan_tpu_torch.comm import LocalComm as TComm
from partisan_tpu_torch.config import DEFAULT_CHANNEL
from partisan_tpu_torch.config import ChannelSpec as TChannelSpec
from partisan_tpu_torch.config import Config as TConfig
from partisan_tpu_torch.models.echo import CLIENT, Echo as TEcho
from partisan_tpu_torch.ops import msg as msg_ops
from partisan_tpu_torch.ops.plane import Planes
from tests.test_channels import Flood as JFlood
from tests.test_torch_cluster import assert_same

torch.set_num_threads(1)


def make_cfgs(n, parallelism, **kw):
    specs = [(name, p) for name, p in zip(
        (DEFAULT_CHANNEL, "partisan_membership", "rpc", "broadcast"),
        parallelism)]
    return (JConfig(n_nodes=n, channel_capacity=True, channels=tuple(
                JChannelSpec(nm, parallelism=p) for nm, p in specs), **kw),
            TConfig(n_nodes=n, channel_capacity=True, channels=tuple(
                TChannelSpec(nm, parallelism=p) for nm, p in specs), **kw))


def random_records(rng, cfg, n, width, live):
    """int words of ``width`` records per node, ``live`` of them sent."""
    words = []
    for i, dt in enumerate(cfg.wire_dtypes):
        info = np.iinfo(np.dtype(str(dt).replace("torch.", "")))
        words.append(rng.integers(info.min, info.max, (n, width),
                                  endpoint=True).astype(info.dtype))
    words[T.W_KIND] = np.where(rng.random((n, width)) < live, 40, 0) \
        .astype(np.int8)
    words[T.W_DST] = rng.integers(0, n, (n, width)).astype(np.int32)
    words[T.W_CHANNEL] = rng.integers(0, 4, (n, width)).astype(np.int8)
    words[T.W_LANE] = np.where(rng.random((n, width)) < 0.5,
                               rng.integers(0, 6, (n, width)),
                               words[T.W_LANE]).astype(np.int32)
    return words


@pytest.mark.parametrize("par,rate,outbox_cap", [
    ((1, 1, 1, 1), 1, 12), ((2, 1, 2, 2), 3, 12), ((4, 2, 1, 4), 1, 12),
    ((4, 4, 4, 4), 3, 12), ((1, 2, 4, 1), 1, 3),
])
def test_throttle_bit_identical(par, rate, outbox_cap):
    n, E = 6, 20
    jcfg, tcfg = make_cfgs(n, par, lane_rate=rate, outbox_cap=outbox_cap)
    rng = np.random.default_rng(sum(par) * 10 + rate + outbox_cap)
    ob = random_records(rng, tcfg, n, outbox_cap, 0.6)
    em = random_records(rng, tcfg, n, E, 0.7)
    shed0 = np.int32(5)
    j_ob, j_out = jchannels.throttle(
        jcfg, JComm(n, 32, jcfg.msg_words),
        jchannels.OutboxState(
            data=jplane.Planes(tuple(jnp.asarray(w) for w in ob)),
            shed=jnp.int32(shed0)),
        jplane.Planes(tuple(jnp.asarray(w) for w in em)))
    t_ob, t_out = tchannels.throttle(
        tcfg, TComm(n, 32, tcfg.msg_words),
        tchannels.OutboxState(
            data=Planes(torch.as_tensor(w) for w in ob),
            shed=torch.tensor(shed0)),
        Planes(torch.as_tensor(w) for w in em))
    assert_same((j_ob, j_out), (t_ob, t_out), f"{par} {rate}")
    assert int(tchannels.shed_delta(tchannels.OutboxState(
        data=(), shed=torch.tensor(shed0)), t_ob)) == int(
            jchannels.shed_delta(jchannels.OutboxState(
                data=(), shed=jnp.int32(shed0)), j_ob))
    if outbox_cap == 3:
        assert int(t_ob.shed) > shed0       # the outbox overflowed
    assert int((t_out[T.W_KIND] != 0).sum()) > 0
    if rate == 1:                           # some sends deferred
        assert int((t_ob.data[T.W_KIND] != 0).sum()) > 0


class FloodState(NamedTuple):
    got: torch.Tensor
    sent: torch.Tensor


class Flood:
    """tests/test_channels.py's Flood: node 0 emits BURST messages to
    node 1 each round while ``rnd < 4``, lanes spread by partition key."""

    name = "flood"
    BURST = 8

    def init(self, cfg, comm):
        z = torch.zeros(comm.n_local, dtype=torch.int32, device=comm.device)
        return FloodState(got=z, sent=z.clone())

    def step(self, cfg, comm, state, ctx, nbrs):
        gids = comm.local_ids()
        got = state.got + (ctx.inbox.data[T.W_KIND] == T.MsgKind.APP) \
            .sum(dim=1, dtype=torch.int32)
        fire = (gids == 0) & (ctx.rnd < 4)
        lanes = torch.arange(self.BURST, dtype=torch.int32,
                             device=gids.device)
        emitted = msg_ops.build(
            cfg, int(T.MsgKind.APP), gids[:, None],
            torch.where(fire[:, None], 1, -1), lane=lanes[None, :],
            payload=(ctx.rnd.expand(gids.shape[0], 1),))
        sent = state.sent + torch.where(fire, self.BURST, 0) \
            .to(torch.int32)
        return FloodState(got=got, sent=sent), emitted


def lockstep(jcl, tcl, rounds, per_round=None):
    """Step both sides from the reference's init state carried across
    (the model's own init on the port side: the Flood probe's state type
    is this file's), comparing every leaf after every round."""
    js = jcl.init()
    ts = state_io.state_from_numpy(jax.device_get(js._replace(model=())),
                                   device="cpu")._replace(
        model=tcl.model.init(tcl.cfg, tcl.comm))
    assert_same(js, ts, "init")
    for r in range(rounds):
        js, ts = jcl.step(js), tcl.step(ts)
        assert_same(js, ts, f"round {r}")
        if per_round is not None:
            per_round(ts)
    return ts


def flood_pair(parallelism, **kw):
    def kwargs(spec):
        return dict(n_nodes=4, seed=5, peer_service_manager="static",
                    channel_capacity=True, lane_rate=1,
                    channels=(spec(DEFAULT_CHANNEL,
                                   parallelism=parallelism),), **kw)
    return (JCluster(JConfig(**kwargs(JChannelSpec)), model=JFlood()),
            TCluster(TConfig(**kwargs(TChannelSpec)), model=Flood(),
                     device="cpu"))


@pytest.mark.parametrize("parallelism,extra", [
    (1, {}), (4, {}), (8, {}), (1, dict(outbox_cap=4)),
])
def test_flood_throttling_bit_identical(parallelism, extra):
    """test_parallelism_throttles_per_edge_throughput (parallelism 1, 4,
    8) and test_outbox_overflow_sheds_with_accounting (outbox_cap=4),
    with test_fifo_preserved_under_deferral's order check on the
    receiver's inbox every round."""
    per, seen = [], []

    def watch(ts):
        per.append(int(ts.model.got[1]) - sum(per))
        app = ts.inbox.data[T.W_KIND][1] == T.MsgKind.APP
        seen.extend(int(x) for x in ts.inbox.data[T.HDR_WORDS][1][app])

    ts = lockstep(*flood_pair(parallelism, **extra), 40, watch)
    assert max(per) <= parallelism
    assert seen == sorted(seen) and len(seen) == int(ts.model.got[1])
    if extra:
        assert int(ts.outbox.shed) > 0 and int(ts.model.got[1]) < 32
    else:
        assert max(per) > parallelism // 2
    if parallelism == 8:
        assert int(ts.model.got[1]) == 32 and int(ts.outbox.shed) == 0


def test_echo_bit_identical():
    """One Echo run at n=2, concurrency 4 over one lane at lane_rate 1
    (config 6's cell shape), to completion."""
    conc, msgs = 4, 6

    def kwargs(spec):
        return dict(n_nodes=2, seed=11, peer_service_manager="static",
                    channel_capacity=True, lane_rate=1,
                    outbox_cap=max(32, 2 * conc),
                    channels=(spec(DEFAULT_CHANNEL, parallelism=1),))

    tm = TEcho(concurrency=conc, num_messages=msgs)
    ts = lockstep(JCluster(JConfig(**kwargs(JChannelSpec)),
                           model=JEcho(concurrency=conc, num_messages=msgs)),
                  TCluster(TConfig(**kwargs(TChannelSpec)), model=tm,
                           device="cpu"), 2 * msgs * conc + 4)
    assert tm.done(ts.model)
    assert int(ts.model.echoed[CLIENT].sum()) == conc * msgs


def test_fully_connected_and_parallelism_checks():
    f = tf.crash(tf.none(4), 2)
    fc = tchannels.fully_connected(TConfig(n_nodes=4), f.alive)
    want = jchannels.fully_connected(JConfig(n_nodes=4),
                                     jnp.asarray(f.alive.numpy()))
    np.testing.assert_array_equal(fc.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        TConfig(channels=(TChannelSpec(DEFAULT_CHANNEL, parallelism=0),))
    with pytest.warns(UserWarning):
        TConfig(channels=(TChannelSpec(DEFAULT_CHANNEL, parallelism=2),))
