"""The port's kernel build and its CUDA and Triton kernels against their
plain versions.  This file imports no JAX, so the card-only cases run on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -m gpu

Without a card those cases skip (a CUDA kernel has no CPU mode); the
build-path cases run everywhere."""

import numpy as np
import pytest
import torch

from partisan_tpu_torch import kernels, probe
from partisan_tpu_torch.ops import plane as plane_ops

BENCH_DTYPES = [torch.int8, torch.int32, torch.int32, torch.int8,
                torch.int16, torch.int32, torch.int32, torch.int8] \
    + [torch.int32] * 8


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel whose nvcc fails raises with the compiler's exit, and
    leaves no library behind."""
    src = tmp_path / "broken.cu"
    src.write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "source", lambda: src)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_keyed_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(kernels, "source", lambda: src)
    first = kernels.lib_path()
    src.write_text("// two\n")
    assert kernels.lib_path() != first
    assert first.parent == kernels.BUILD_DIR


def test_launch_counts_reset():
    kernels.launches["interleave"] += 3
    kernels.reset_launches()
    assert kernels.launches == {"interleave": 0, "minimal": 0}


def _cuda_planes(shape, dtypes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for dt in dtypes:
        info = torch.iinfo(dt)
        out.append(torch.from_numpy(rng.integers(
            info.min, info.max, shape, endpoint=True)).to(dt).cuda())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", [
    ((32768, 77), BENCH_DTYPES),
    ((4099,), BENCH_DTYPES[:12]),
    ((7, 3), [torch.int16]),
])
def test_interleave_cuda_kernel_matches_plain(shape, dtypes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the interleave kernel has no CPU "
                    "mode")
    ws = _cuda_planes(shape, dtypes, seed=len(dtypes))
    before = kernels.launches["interleave"]
    got = plane_ops.interleave(plane_ops.Planes(ws))
    torch.cuda.synchronize()
    assert kernels.launches["interleave"] == before + 1
    assert torch.equal(got, plane_ops.interleave_plain(ws))
    out = torch.full(tuple(shape) + (len(ws),), -7, dtype=torch.int32,
                     device="cuda")
    assert plane_ops.interleave(plane_ops.Planes(ws), out=out) is out
    assert torch.equal(out, got)


@pytest.mark.gpu
def test_interleave_cuda_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the interleave kernel has no CPU "
                    "mode")
    w = torch.zeros((8, 6), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        plane_ops.interleave(plane_ops.Planes([w.t()]))   # not contiguous
    with pytest.raises(TypeError):
        plane_ops.interleave(plane_ops.Planes([w.to(torch.int64)]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 256), (1000, 37), (1,)])
def test_minimal_triton_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton kernel has no CPU mode")
    x = torch.from_numpy(np.random.default_rng(7).integers(
        -2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)).cuda()
    before = kernels.launches["minimal"]
    got = probe.minimal(x)
    torch.cuda.synchronize()
    assert kernels.launches["minimal"] == before + 1
    assert torch.equal(got, probe.minimal_plain(x))
    assert kernels.TRITON_CACHE.is_dir()
