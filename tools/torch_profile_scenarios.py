"""Where the scenario suite's rounds spend their time on the card: SCAMP
v2 (config 4) and the health plane's snapshot round (config 3 with
``--health``).

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_profile_scenarios.py [--n4 10000] [--n3 10000]
        [--rounds 10]

Config 4's configuration is booted as the scenario boots it up to a
quarter of ``--n4``, the rest of the nodes are queued to join at the
scenario's admission stagger (40 a round), and ``--rounds`` rounds of
that join wave are traced: wall, device time, idle share, kernel
launches per round and the top kernels (tools/torch_profile_round.py's
window), beside the inbox slots the SCAMP handler loops over in each of
those rounds.  Then the boot is finished with the scenario's six settle
executions, one churn step is taken, and ``--rounds`` churn rounds are
traced the same way.  Config 3's configuration
with the health plane on (snapshots every K_PROG rounds) is booted and
its broadcast queued; a window of K_PROG rounds holds one snapshot
round, a window of the same rounds with the plane off holds none, and
one more window traces ``health.record_snapshot`` alone.  One JSON line
per window, the card's name and power limit on each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_round import card, window  # noqa: E402

from partisan_tpu_torch import faults, health  # noqa: E402
from partisan_tpu_torch import scenarios as sc  # noqa: E402
from partisan_tpu_torch.cluster import Cluster  # noqa: E402
from partisan_tpu_torch.config import Config  # noqa: E402
from partisan_tpu_torch.models.plumtree import Plumtree  # noqa: E402
from partisan_tpu_torch.types import W_KIND  # noqa: E402


def slots_used(st) -> int:
    """Inbox slots the SCAMP handler loops over next round: up to the
    last slot holding a message anywhere."""
    col = (st.inbox.data[W_KIND] != 0).any(dim=0).nonzero()
    return int(col.max()) + 1 if col.numel() else 0


def scamp_windows(n: int, rounds: int, top: int, tag: str) -> None:
    cfg = Config(n_nodes=n, seed=4, peer_service_manager="scamp_v2",
                 msg_words=16, partition_mode="groups", inbox_cap=96)
    cl = Cluster(cfg)

    def trace(st, label):
        used, s = [], st
        for _ in range(rounds):
            used.append(slots_used(s))
            s = cl.step(s)
        print(json.dumps({"config": 4, "n": n, "slots_used": used,
                          "inbox_cap": cfg.inbox_cap,
                          **window(lambda: cl.steps(st, rounds), rounds,
                                   label, top, tag)}), flush=True)
        return s

    first = n // 4
    st = sc._boot_overlay(cl, first, stagger=40, wave_execs=2)
    rest = np.arange(first, n, dtype=np.int32)
    rng = np.random.default_rng(7)
    window_rounds = -(-rest.shape[0] // 40)
    st = st._replace(manager=cl.manager.join_many(
        cfg, st.manager, rest,
        rng.integers(0, first, rest.shape[0]).astype(np.int32),
        (int(st.rnd) + rng.integers(0, window_rounds, rest.shape[0]))
        .astype(np.int32)))
    st = trace(st, "scamp_v2_join_wave")
    for _ in range(-(-window_rounds // sc.K_PROG) + 6):
        st = cl.steps(st, sc.K_PROG)
    p = 0.30 / 60.0
    st = st._replace(faults=faults.churn_step(st.faults, cfg.seed, st.rnd,
                                              p, p))
    trace(st, "scamp_v2_churn")


def health_windows(n: int, top: int, tag: str) -> None:
    rounds = sc.K_PROG
    model = Plumtree()
    base = dict(n_nodes=n, seed=3, peer_service_manager="hyparview",
                msg_words=16, partition_mode="groups",
                emit_compact=32 if n > 4096 else 0)
    cfg = Config(health=sc.K_PROG, health_ring=512, **base)
    cl = Cluster(cfg, model=model)
    cl_off = Cluster(Config(**base), model=model)
    st = sc._boot_overlay(cl, n)
    st = st._replace(faults=faults.set_link_drop(st.faults, 0.05))
    st = st._replace(model=model.broadcast(st.model, 0, 0, int(st.rnd)))
    print(json.dumps({"config": 3, "n": n, "health": cfg.health,
                      **window(lambda: cl.steps(st, rounds), rounds,
                               "health_on", top, tag)}), flush=True)
    st_off = st._replace(health=())
    print(json.dumps({"config": 3, "n": n, "health": 0,
                      **window(lambda: cl_off.steps(st_off, rounds),
                               rounds, "health_off", top, tag)}),
          flush=True)
    nbrs = cl.manager.neighbors(cfg, st.manager, cl.comm)

    def snap():
        health.record_snapshot(cfg, cl.comm, st.health, rnd=st.rnd,
                               nbrs_local=nbrs,
                               alive_global=st.faults.alive, cov_ok=True,
                               partition=st.faults.partition)

    print(json.dumps({"config": 3, "n": n,
                      **window(snap, 1, "record_snapshot", top, tag)}),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n4", type=int, default=10_000)
    ap.add_argument("--n3", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_scenarios: no CUDA device", file=sys.stderr)
        return 2
    tag = card()
    health_windows(args.n3, args.top, tag)
    scamp_windows(args.n4, args.rounds, args.top, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
