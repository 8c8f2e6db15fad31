"""PyTorch/CUDA port of partisan_tpu for one NVIDIA H100.

The JAX package ``partisan_tpu`` is the reference: given the same
``Config``, this package produces the same ``ClusterState`` leaves after
every round, bit for bit, plus the same send trace and convergence round.
It imports torch and numpy only — never jax, never ``partisan_tpu`` (it
keeps its own copies of the reference's jax-free modules).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); they raise when no GPU is present.
"""

from partisan_tpu_torch.config import (  # noqa: F401
    Config, ControlConfig, HyParViewConfig, PlumtreeConfig)
