"""Host time per call of the port's kernel launch path, step by step.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_launch_cost.py [--batches 40] [--per-batch 50]

When a kernel's device time is a few microseconds, its call takes as long
as the host needs to launch it.  This tool times, on the host clock, each
step of the two wrappers' path (``plane.interleave`` on the probe's 16
int32 planes at n=8192, ``probe.minimal`` at [256, 256]): the argument
checks, the output's allocation, the pointer packing, the ctypes launch
alone, and the whole wrapper; beside them the library calls that compute
the same functions, the bare ctypes call with the interpreter lock kept
and released, and the reads a launch can make for the current stream
and device.  Each figure is the median over ``--batches`` batches
of ``--per-batch`` back-to-back calls with no synchronize inside a batch
(the card drains between batches), with the quartiles beside it.  The
whole calls are also timed by CUDA events (median of 5 runs of 200
calls): that is the time the card sees per call.  The card's name and
power limit ride every line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from partisan_tpu_torch import kernels, probe  # noqa: E402
from partisan_tpu_torch.ops import plane as plane_ops  # noqa: E402
from tools.torch_profile_round import card  # noqa: E402


def host_us(fn, batches: int, per_batch: int) -> dict:
    """Median and quartiles of host microseconds per call."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(per_batch):
            fn()
        per_call.append((time.perf_counter() - t0) / per_batch * 1e6)
        torch.cuda.synchronize()
    q = statistics.quantiles(per_call, n=4)
    return {"host_us": statistics.median(per_call), "q1_us": q[0],
            "q3_us": q[2]}


def event_us(fn, reps: int = 200, runs: int = 5) -> float:
    """Median over ``runs`` of the CUDA-event time per call."""
    out = []
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps * 1e3)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--per-batch", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_launch_cost: no CUDA device", file=sys.stderr)
        return 2
    tag = card()
    dev = torch.cuda.current_device()
    n = 8192
    planes = torch.arange(probe.W * n * probe.S, dtype=torch.int32,
                          device="cuda").reshape(probe.W, n, probe.S)
    ws = tuple(planes.unbind(0))
    m, code, packer = plane_ops.interleave_args(ws)
    out = torch.empty(ws[0].shape + (len(ws),), dtype=torch.int32,
                      device="cuda")
    packed = packer.pack(*[w.data_ptr() for w in ws])
    x = torch.ones((256, 256), dtype=torch.int32, device="cuda")
    y = torch.empty_like(x)
    # minimal_launch with no elements returns before any CUDA call: the
    # bare cost of a ctypes call, with and without the interpreter lock
    lock_kept = kernels._load()["minimal"]
    lock_released = ctypes.CDLL(str(kernels.lib_path())).minimal_launch
    lock_released.argtypes = lock_kept.argtypes
    lock_released.restype = ctypes.c_int
    steps = [
        ("interleave: whole wrapper",
         lambda: plane_ops.interleave(plane_ops.Planes(ws)), True),
        ("interleave: whole wrapper, out= given",
         lambda: plane_ops.interleave(plane_ops.Planes(ws), out=out), True),
        ("interleave: interleave_args", lambda: plane_ops.interleave_args(ws),
         False),
        ("interleave: allocate the output",
         lambda: ws[0].new_empty((*ws[0].shape, len(ws)),
                                 dtype=torch.int32), False),
        ("interleave: pack the plane pointers",
         lambda: packer.pack(*[w.data_ptr() for w in ws]), False),
        ("interleave: kernels.launch alone",
         lambda: kernels.launch("interleave", dev, packed, code, len(ws), m,
                                out.data_ptr()), False),
        ("permute(1, 2, 0).contiguous()",
         lambda: planes.permute(1, 2, 0).contiguous(), True),
        ("minimal: whole wrapper", lambda: probe.minimal(x), True),
        ("minimal: torch.empty_like", lambda: torch.empty_like(x), False),
        ("minimal: kernels.launch alone",
         lambda: kernels.launch("minimal", dev, x.data_ptr(), y.data_ptr(),
                                x.numel()), False),
        ("torch.mul(x, 2)", lambda: torch.mul(x, 2), True),
        ("ctypes call, lock kept (PyDLL, the port's)",
         lambda: lock_kept(0, 0, 0, 0), False),
        ("ctypes call, lock released (CDLL)",
         lambda: lock_released(0, 0, 0, 0), False),
        ("read: torch._C._cuda_getCurrentRawStream",
         lambda: torch._C._cuda_getCurrentRawStream(dev), False),
        ("read: torch.cuda.current_stream().cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream, False),
        ("read: torch._C._cuda_getDevice", torch._C._cuda_getDevice, False),
        ("read: torch.cuda.current_device", torch.cuda.current_device, False),
    ]
    for label, fn, events in steps:
        row = {"step": label, "card": tag,
               **host_us(fn, args.batches, args.per_batch)}
        if events:
            row["event_us"] = event_us(fn)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
