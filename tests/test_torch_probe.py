"""The port's kernel-toolchain probe (partisan_tpu_torch/probe.py) against
the reference's Pallas kernels (tools/pallas_probe.py) run in interpret
mode on the CPU, bit for bit: the minimal kernel (``x * 2``) and the
interleave on int32 planes.  Inputs come from numpy seeds.  The CUDA
minimal kernel itself runs only on the card
(tests/test_torch_kernels.py, ``-m gpu``)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu_torch import kernels, probe
from partisan_tpu_torch.ops import plane as plane_ops
from tools import pallas_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_minimal(x: np.ndarray) -> np.ndarray:
    pl, _, minimal_kernel = pallas_probe._kernels()
    fn = pl.pallas_call(minimal_kernel,
                        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
                        interpret=True)
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(256, 256), (1000, 37)])
def test_minimal_plain_matches_pallas_interpret(shape):
    x = np.random.default_rng(len(shape) + shape[1]).integers(
        -2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)
    got = probe.minimal(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _pallas_minimal(x))


def test_interleave_probe_matches_pallas_interpret():
    """probe_interleave's planes and result against the reference's
    gridded interleave kernel at the same shape."""
    n = 64
    pl, interleave_kernel, _ = pallas_probe._kernels()
    planes = jnp.arange(pallas_probe.W * n * pallas_probe.S,
                        dtype=jnp.int32).reshape(pallas_probe.W, n,
                                                 pallas_probe.S)
    ref = pl.pallas_call(
        interleave_kernel, grid=(2,),
        in_specs=[pl.BlockSpec((pallas_probe.W, n // 2, pallas_probe.S),
                               lambda i: (0, i, 0))],
        out_specs=pl.BlockSpec((n // 2, pallas_probe.S, pallas_probe.W),
                               lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, pallas_probe.S, pallas_probe.W),
                                       jnp.int32),
        interpret=True)(planes)
    tp = torch.from_numpy(np.array(planes))
    got = plane_ops.interleave(plane_ops.Planes(tp.unbind(0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    r = probe.probe_interleave(n, device="cpu")
    assert r["ok"] and r["probe"] == f"interleave_n{n}"
    assert probe.probe_minimal(device="cpu")["ok"]


def test_minimal_wrapper_refuses_what_the_kernel_does_not_take():
    before = kernels.launches["minimal"]
    with pytest.raises(ValueError):
        probe.minimal(torch.ones(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):   # the kernel takes CUDA int32 only
        probe.minimal_cuda(torch.ones(4, dtype=torch.int32))
    assert kernels.launches["minimal"] == before


def test_probe_cli_cpu_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "partisan_tpu_torch.probe", "--device",
         "cpu", "--shapes", "1024"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [r["probe"] for r in lines[:-1]] == ["minimal_256x256",
                                                "interleave_n1024"]
    assert all(r["ok"] for r in lines[:-1])
    assert lines[-1] == {"verdict": "PASS", "device": "cpu",
                         "kernels": "plain"}
