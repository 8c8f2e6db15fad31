"""The fanout governor's and the healing escalation's A/B arms in the
port against the JAX reference on the CPU, cut short: each arm's dict
and its final state leaf for leaf, the decision rings and the moves
``decisions`` derives from them.  Tolerance 0 throughout (config 8's
backpressure arm and the calm closed-loop round are in
test_torch_control.py)."""

import jax
import numpy as np
import torch

from partisan_tpu import control as jcontrol
from partisan_tpu import scenarios as jsc
from partisan_tpu_torch import control as tcontrol
from partisan_tpu_torch import scenarios as tsc
from partisan_tpu_torch import state_io
from test_torch_control import assert_arm

torch.set_num_threads(1)


def test_fanout_arm_bit_identical():
    j = jsc.fanout_ab_arm(True, n=48, waves=3)
    t = tsc.fanout_ab_arm(True, n=48, waves=3, device="cpu")
    ts = t["_state"]
    assert_arm(j, t, "fanout")
    assert t["fanout_adjustments"] > 0
    snap = tcontrol.snapshot(ts.control)
    assert snap["fanout"]["rounds"].max() == int(ts.rnd) - 1
    jsnap = jcontrol.snapshot(jax.tree_util.tree_map(
        np.asarray, state_io.state_to_numpy(ts.control)))
    for k in ("rounds", "cap"):
        np.testing.assert_array_equal(snap["fanout"][k],
                                      jsnap["fanout"][k])
    assert tcontrol.decisions(snap) == jcontrol.decisions(jsnap)


def test_healing_arm_bit_identical():
    j = jsc.healing_ab_arm(True, n=48)
    t = tsc.healing_ab_arm(True, n=48, device="cpu")
    ts = t["_state"]
    assert_arm(j, t, "healing")
    assert t["rounds_to_heal"] != -1 and int(ts.control.healing.adjustments)
    snap = tcontrol.snapshot(ts.control)
    assert snap["healing"]["boost"].max() >= 1
