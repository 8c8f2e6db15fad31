"""Kernel-toolchain probe (port of ``tools/pallas_probe.py``).

Two probes, each printed as one JSON line, then a verdict line:

- ``probe_minimal``: ``int32[256, 256]`` ones times 2 through the minimal
  kernel (CUDA, ``csrc/minimal.cu``, on the card);
- ``probe_interleave(n)``: ``int32`` word planes ``[16, n, 16]``
  (arange) through the plane->wire interleave (CUDA,
  ``csrc/interleave.cu``, on the card), held against
  ``planes.permute(1, 2, 0)``.

Run:  python -m partisan_tpu_torch.probe [--shapes 8192 32768] [--device cpu]

The device defaults to the card.  ``--device cpu`` runs the kernels'
plain versions, because the caller asked for them, and the verdict line
says so.  Exit code 0 on PASS, 1 on FAIL.

The minimal kernel's wrapper :func:`minimal` lives here with its plain
version :func:`minimal_plain`: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (or raises).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from partisan_tpu_torch import device as device_mod
from partisan_tpu_torch import kernels
from partisan_tpu_torch.ops import plane as plane_ops

S = 16            # wire slots per node
W = 16            # int32 words per message


def minimal_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the minimal kernel."""
    return x * 2


def minimal(x: torch.Tensor) -> torch.Tensor:
    """``x * 2``: the plain version for a CPU tensor, the CUDA kernel for
    a CUDA tensor."""
    if x.is_cuda:
        return minimal_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"minimal: unsupported device {x.device}")
    return minimal_plain(x)


def minimal_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/minimal.cu`` on a contiguous int32 CUDA tensor into a
    new tensor."""
    if not x.is_cuda or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("minimal kernel: needs a contiguous int32 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        kernels.launch("minimal", x.get_device(), x.data_ptr(),
                       out.data_ptr(), n)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_minimal(device=None) -> dict:
    """``[256, 256]`` int32 ones times 2 through the minimal kernel."""
    dev = device_mod.resolve(device)
    x = torch.ones((256, 256), dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    y = minimal(x)
    _sync(dev)
    wall = time.perf_counter() - t0
    return {"probe": "minimal_256x256", "ok": bool((y == 2).all()),
            "first_call_wall_s": wall}


def probe_interleave(n: int, device=None) -> dict:
    """int32 planes ``[W, n, S]`` (arange) through the interleave, held
    against ``planes.permute(1, 2, 0)``."""
    dev = device_mod.resolve(device)
    planes = torch.arange(W * n * S, dtype=torch.int32,
                          device=dev).reshape(W, n, S)
    t0 = time.perf_counter()
    out = plane_ops.interleave(plane_ops.Planes(planes.unbind(0)))
    _sync(dev)
    wall = time.perf_counter() - t0
    return {"probe": f"interleave_n{n}",
            "ok": bool(torch.equal(out, planes.permute(1, 2, 0))),
            "total_mb": n * S * W * 4 / 2 ** 20,
            "first_call_wall_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", type=int, nargs="*", default=[8192, 32768],
                    help="protocol widths to probe the interleave at")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    results = [probe_minimal(dev)] + [probe_interleave(n, dev)
                                      for n in args.shapes]
    for r in results:
        print(json.dumps(r), flush=True)
    ok = all(r["ok"] for r in results)
    print(json.dumps({"verdict": "PASS" if ok else "FAIL",
                      "device": str(dev),
                      "kernels": "plain" if dev.type == "cpu"
                      else "hand-written"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
