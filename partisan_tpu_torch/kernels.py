"""Build, load and count the port's hand-written kernels.

- ``csrc/interleave.cu``, CUDA C++ with a plain C interface: at first use
  it is compiled with nvcc for ``sm_90a`` into ``build/partisan_tpu_torch/``
  at the repository root, under a name keyed by a hash of its source,
  and loaded with ctypes.  A failed build raises.
- ``csrc/minimal_triton.py``, a Triton kernel: imported (and with it
  ``triton``) only by :func:`minimal_fn`, which first points Triton's
  cache at ``build/partisan_tpu_torch/triton/``; Triton compiles it
  there at its first launch.

``launches`` counts, per kernel, the launches its wrapper made — the
evidence that a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "partisan_tpu_torch"
TRITON_CACHE = BUILD_DIR / "triton"

launches = {"interleave": 0, "minimal": 0}
_fn = None
_minimal = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def source() -> Path:
    return _PKG / "csrc" / "interleave.cu"


def lib_path() -> Path:
    src = source()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}_{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build partisan_tpu_torch's kernels")


def build() -> bool:
    """Compile the kernel unless it is built; True if it compiled now."""
    out = lib_path()
    if out.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(tmp), str(source())]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return True


def interleave_fn():
    """The loaded C entry point ``interleave_launch`` (built on demand)."""
    global _fn
    if _fn is None:
        build()
        fn = ctypes.CDLL(str(lib_path())).interleave_launch
        fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def minimal_fn():
    """The Triton kernel ``double_kernel`` of ``csrc/minimal_triton.py``;
    its import brings in ``triton`` (absent where there is no card)."""
    global _minimal
    if _minimal is None:
        os.environ["TRITON_CACHE_DIR"] = str(TRITON_CACHE)
        from partisan_tpu_torch.csrc import minimal_triton
        _minimal = minimal_triton.double_kernel
    return _minimal
