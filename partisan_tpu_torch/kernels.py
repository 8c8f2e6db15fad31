"""Build, load, launch and count the port's hand-written kernels.

Both kernels are CUDA C++ with a plain C interface, in ``csrc/``:
``interleave.cu`` (the plane->wire interleave) and ``minimal.cu`` (the
probe's ``x * 2``).  At first use one nvcc call compiles both for
``sm_90a`` into one shared library under ``build/partisan_tpu_torch/`` at
the repository root, named by a hash of both sources and the flags, and
ctypes loads it once, with every entry point's argument types set then.
A failed build raises.  The compiler's report (``-Xptxas -v``: registers,
shared memory and spills per kernel) is kept beside the library as
``<name>.log``.

:func:`launch` is the one launch path of both wrappers: it calls a C
launch function on the current stream of the tensors' device, raises on
the CUDA error it returns, and counts the launch in ``launches`` — the
evidence that a run went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "partisan_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> argument types of its C launch function ``<name>_launch``
# in ``csrc/<name>.cu``, without the stream that every launch takes last
_SIGNATURES = {
    # plane pointer array, size code, W, records, out
    "interleave": (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p),
    # x, out, elements
    "minimal": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong),
}

launches = {"interleave": 0, "minimal": 0}
_entry: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sources() -> list:
    return [_PKG / "csrc" / f"{name}.cu" for name in _SIGNATURES]


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"partisan_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build partisan_tpu_torch's kernels")


def nvcc_command(out: Path) -> list:
    """The one nvcc call that builds every kernel source into ``out``."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out),
            *[str(s) for s in sources()]]


def build() -> bool:
    """Compile the library unless it is built; True if it compiled now."""
    out = lib_path()
    if out.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return True


def _load() -> dict:
    """Build if needed, load the library once and type its entry points."""
    if not _entry:
        build()
        # PyDLL keeps the interpreter lock across the call: the launch
        # functions only enqueue work, and releasing and retaking the lock
        # would cost about as much as the ctypes call itself
        lib = ctypes.PyDLL(str(lib_path()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = (*args, ctypes.c_void_p)
            fn.restype = ctypes.c_int
            _entry[name] = fn
    return _entry


def launch(name: str, index: int, *args) -> None:
    """Launch kernel ``name`` with ``args`` on the current stream of CUDA
    device ``index`` (entering a device guard only when that is not the
    current device), raise on a CUDA error, and count the launch."""
    fn = (_entry or _load())[name]
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
