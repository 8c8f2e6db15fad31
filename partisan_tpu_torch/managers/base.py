"""Per-round context handed to managers and models.

Port of ``partisan_tpu/managers/base.py``'s ``RoundCtx``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from partisan_tpu_torch.ops.exchange import Inbox


class RoundCtx(NamedTuple):
    rnd: torch.Tensor    # int32 scalar — current round number
    alive: torch.Tensor  # bool[n] — crash mask AND active-prefix mask
    keys: torch.Tensor   # int64[n, 2] — per-node threefry round keys
    inbox: Inbox         # last round's deliveries
    faults: Any          # faults.FaultState (not prefix-masked)
    n_active: Any = ()   # int32 scalar active prefix width, or ()
    control: Any = ()    # control.ControlState at round start, or ()
    seed: int = 0        # the round's effective seed (cfg.seed)
