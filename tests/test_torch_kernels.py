"""The port's kernel build, the interleave's host-side checks, and its two
CUDA kernels against their plain versions.  This file imports no JAX, so
the card-only cases run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -m gpu

Without a card those cases skip (a CUDA kernel has no CPU mode); the
build-path and argument-check cases run everywhere, on CPU or ``meta``
tensors."""

import numpy as np
import pytest
import torch

from partisan_tpu_torch import kernels, probe
from partisan_tpu_torch.ops import plane as plane_ops

BENCH_DTYPES = [torch.int8, torch.int32, torch.int32, torch.int8,
                torch.int16, torch.int32, torch.int32, torch.int8] \
    + [torch.int32] * 8
MIXED = [torch.int8, torch.int16, torch.int32]


def _fake_sources(tmp_path, monkeypatch, texts):
    srcs = []
    for i, text in enumerate(texts):
        src = tmp_path / f"k{i}.cu"
        src.write_text(text)
        srcs.append(src)
    monkeypatch.setattr(kernels, "sources", lambda: list(srcs))
    return srcs


def test_failed_build_raises(tmp_path, monkeypatch):
    """A library whose nvcc call fails raises with the compiler's exit,
    and leaves no library behind."""
    _fake_sources(tmp_path, monkeypatch,
                  ["this is not CUDA\n", "nor this\n"])
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("changed", [0, 1])
def test_library_name_keyed_by_source_hash(tmp_path, monkeypatch, changed):
    """The library's name changes when either source changes."""
    srcs = _fake_sources(tmp_path, monkeypatch, ["// one\n", "// two\n"])
    first = kernels.lib_path()
    srcs[changed].write_text("// changed\n")
    assert kernels.lib_path() != first
    assert first.parent == kernels.BUILD_DIR


def test_one_nvcc_call_builds_both_sources(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    cmd = kernels.nvcc_command(kernels.BUILD_DIR / "lib.so")
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    names = [a.rsplit("/", 1)[-1] for a in cmd if a.endswith(".cu")]
    assert names == ["interleave.cu", "minimal.cu"]
    assert all(s.exists() for s in kernels.sources())


def test_launch_counts_reset():
    kernels.launches["interleave"] += 3
    kernels.reset_launches()
    assert kernels.launches == {"interleave": 0, "minimal": 0}


@pytest.mark.parametrize("dtypes,code", [
    (BENCH_DTYPES, sum(({torch.int8: 0, torch.int16: 1, torch.int32: 2}[dt]
                        << (2 * i)) for i, dt in enumerate(BENCH_DTYPES))),
    ([torch.int32] * 16, int("10" * 16, 2)),
    ([torch.int16], 1),
    ([torch.int8, torch.int32] * 16, int("1000" * 16, 2)),
])
def test_size_code_packing(dtypes, code):
    """2 bits per plane (log2 of its element size), plane 0 lowest; the
    packer carries one native pointer per plane."""
    got, packer = plane_ops.size_plan(tuple(dtypes))
    assert got == code
    assert packer.size == 8 * len(dtypes)
    ws = [torch.zeros((3, 5), dtype=dt, device="meta") for dt in dtypes]
    m, got2, _ = plane_ops.interleave_args(ws)
    assert (m, got2) == (15, code)


def _refused(kind):
    z = [torch.zeros((4, 6), dtype=torch.int32)] * 3
    if kind == "int64":
        return TypeError, z[:2] + [z[0].to(torch.int64)], None
    if kind == "w33":
        return ValueError, [z[0]] * 33, None
    if kind == "empty":
        return ValueError, [], None
    if kind == "shape":
        return ValueError, z[:2] + [torch.zeros((6, 4), dtype=torch.int32)], \
            None
    if kind == "device":
        return ValueError, z[:2] + [z[0].to("meta")], None
    if kind == "strided":
        return ValueError, z[:2] + [torch.zeros((6, 4),
                                                dtype=torch.int32).t()], None
    if kind == "out_shape":
        return ValueError, z, torch.zeros((4, 6, 4), dtype=torch.int32)
    if kind == "out_dtype":
        return ValueError, z, torch.zeros((4, 6, 3), dtype=torch.int64)
    if kind == "out_strided":
        return ValueError, z, torch.zeros((3, 6, 4),
                                          dtype=torch.int32).permute(2, 1, 0)
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["int64", "w33", "empty", "shape", "device",
                                  "strided", "out_shape", "out_dtype",
                                  "out_strided"])
def test_interleave_args_refuse_what_the_kernel_does_not_take(kind):
    err, ws, out = _refused(kind)
    with pytest.raises(err):
        plane_ops.interleave_args(ws, out)


def test_interleave_cuda_refuses_cpu_planes():
    before = kernels.launches["interleave"]
    ws = [torch.zeros((4, 6), dtype=torch.int32)] * 2
    assert plane_ops.interleave_args(ws)[:2] == (24, 0b1010)
    with pytest.raises(ValueError):
        plane_ops.interleave_cuda(ws)
    assert kernels.launches["interleave"] == before


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _random(shape, dt, rng, offset=0):
    """Random values of ``dt`` on the card; with ``offset`` a view that
    starts that many elements into its buffer (not 16-byte aligned)."""
    info = torch.iinfo(dt)
    vals = torch.from_numpy(rng.integers(info.min, info.max, shape,
                                         endpoint=True)).to(dt)
    n = int(np.prod(shape))
    buf = torch.empty(n + offset, dtype=dt, device="cuda")
    view = buf[offset:].view(shape)
    view.copy_(vals)
    return view


def _check_interleave(ws, out=None):
    before = kernels.launches["interleave"]
    got = plane_ops.interleave(plane_ops.Planes(ws), out=out)
    torch.cuda.synchronize()
    assert kernels.launches["interleave"] == before + 1
    assert torch.equal(got, plane_ops.interleave_plain(ws))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtypes", [
    ((32768, 77), BENCH_DTYPES),
    ((4099,), BENCH_DTYPES[:12]),
    ((7, 3), [torch.int16]),
    ((70001,), [torch.int32]),
    ((70001,), (MIXED * 4)[:12]),
    ((513, 31), BENCH_DTYPES),
    ((70001,), (MIXED * 11)[:32]),
])
def test_interleave_cuda_kernel_matches_plain(shape, dtypes):
    _needs_card()
    rng = np.random.default_rng(len(dtypes))
    ws = [_random(shape, dt, rng) for dt in dtypes]
    got = _check_interleave(ws)
    out = torch.full(tuple(shape) + (len(ws),), -7, dtype=torch.int32,
                     device="cuda")
    assert plane_ops.interleave(plane_ops.Planes(ws), out=out) is out
    assert torch.equal(out, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", MIXED)
@pytest.mark.parametrize("m", [1, 15, 511, 513, 4099, 65536 + 17])
def test_interleave_cuda_ragged_tail(dt, m):
    """Record counts that are not a multiple of the tile or of 16."""
    _needs_card()
    rng = np.random.default_rng(m)
    _check_interleave([_random((m,), dt, rng) for _ in range(16)])


@pytest.mark.gpu
@pytest.mark.parametrize("dt", MIXED)
def test_interleave_cuda_unaligned_views(dt):
    """Planes that start at an odd element offset into their buffer (not
    16-byte aligned), alone and beside aligned planes."""
    _needs_card()
    rng = np.random.default_rng(3)
    m = 3 * 512 + 5
    _check_interleave([_random((m,), dt, rng, offset=1) for _ in range(16)])
    _check_interleave([_random((m,), BENCH_DTYPES[i], rng, offset=i % 2)
                       for i in range(16)])


@pytest.mark.gpu
def test_interleave_cuda_into_out_slices():
    """``out=`` a slice of a ``[3, ...]`` buffer, as ``Cluster.record``
    passes, and an output that is not 16-byte aligned."""
    _needs_card()
    rng = np.random.default_rng(5)
    shape = (1000, 77)
    ws = [_random(shape, dt, rng) for dt in BENCH_DTYPES]
    want = plane_ops.interleave_plain(ws)
    buf = torch.full((3,) + shape + (16,), -7, dtype=torch.int32,
                     device="cuda")
    assert plane_ops.interleave(plane_ops.Planes(ws), out=buf[1]) is not None
    torch.cuda.synchronize()
    assert torch.equal(buf[1], want)
    assert bool((buf[0] == -7).all()) and bool((buf[2] == -7).all())
    flat = torch.full((want.numel() + 1,), -7, dtype=torch.int32,
                      device="cuda")
    odd = flat[1:].view(want.shape)
    plane_ops.interleave(plane_ops.Planes(ws), out=odd)
    torch.cuda.synchronize()
    assert torch.equal(odd, want) and int(flat[0]) == -7


@pytest.mark.gpu
def test_interleave_cuda_rejects_what_the_kernel_does_not_take():
    _needs_card()
    w = torch.zeros((8, 6), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        plane_ops.interleave(plane_ops.Planes([w.t()]))   # not contiguous
    with pytest.raises(TypeError):
        plane_ops.interleave(plane_ops.Planes([w.to(torch.int64)]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((256, 256), 0), ((1000, 37), 0),
                                          ((1,), 0), ((1000, 37), 1),
                                          ((5,), 3), ((4099,), 2)])
def test_minimal_cuda_kernel_matches_plain(shape, offset):
    _needs_card()
    rng = np.random.default_rng(7)
    x = _random(shape, torch.int32, rng, offset=offset)
    before = kernels.launches["minimal"]
    got = probe.minimal(x)
    torch.cuda.synchronize()
    assert kernels.launches["minimal"] == before + 1
    assert torch.equal(got, probe.minimal_plain(x))
    assert torch.equal(got, torch.mul(x, 2))
