"""Device time against host time per call of the port's kernel wrappers.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_kernel_profile.py [--reps 50]

chip_smoke.py times each wrapper with CUDA events over back-to-back
calls; when the host takes longer to launch a call than the card takes
to run it, that reading is the host's.  This tool runs each call
``--reps`` times bare and under torch.profiler and prints one JSON line
per call: wall ms per call, device ms per call (the summed kernel
time), the device idle share and the kernels it ran.  Calls: the
interleave on the bench path's mixed-dtype planes ([32768, 77] x 16)
and on the probe's int32 planes (n=8192, 32768), the minimal kernel at
[256, 256], and beside each its library call (``torch.stack``,
``permute(1, 2, 0).contiguous()``, ``torch.mul``).  The card's name and
power limit ride every line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from partisan_tpu_torch import probe, scenarios as sc  # noqa: E402
from partisan_tpu_torch.ops import plane as plane_ops  # noqa: E402
from tools.torch_profile_round import card, window  # noqa: E402


def _bench_planes() -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    ws = []
    for dt in sc.bench_config(8).wire_dtypes:
        info = torch.iinfo(dt)
        ws.append(torch.randint(info.min, info.max, (32768, 77),
                                generator=gen, device="cuda",
                                dtype=torch.int64).to(dt))
    return ws


def _probe_planes(n: int) -> torch.Tensor:
    return torch.arange(probe.W * n * probe.S, dtype=torch.int32,
                        device="cuda").reshape(probe.W, n, probe.S)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_profile: no CUDA device", file=sys.stderr)
        return 2
    tag = card()
    bench = _bench_planes()
    calls = [("interleave bench [32768,77]x16",
              lambda: plane_ops.interleave(plane_ops.Planes(bench))),
             ("torch.stack bench [32768,77]x16",
              lambda: torch.stack(bench, dim=-1))]
    for n in (8192, 32768):
        planes = _probe_planes(n)
        ws = list(planes.unbind(0))
        calls += [(f"interleave probe n={n}",
                   lambda ws=ws: plane_ops.interleave(plane_ops.Planes(ws))),
                  (f"torch.stack probe n={n}",
                   lambda ws=ws: torch.stack(ws, dim=-1)),
                  (f"permute probe n={n}",
                   lambda p=planes: p.permute(1, 2, 0).contiguous())]
    x = torch.ones((256, 256), dtype=torch.int32, device="cuda")
    calls += [("minimal [256,256]", lambda: probe.minimal(x)),
              ("torch.mul [256,256]", lambda: torch.mul(x, 2))]
    for label, fn in calls:
        fn()                                   # build, load, warm up
        reps = args.reps

        def many(fn=fn, reps=reps):
            for _ in range(reps):
                fn()

        print(json.dumps(window(many, reps, label, 3, tag)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
