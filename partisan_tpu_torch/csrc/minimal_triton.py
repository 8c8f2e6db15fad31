"""Triton source of the probe's minimal kernel: ``out = x * 2`` over
int32 elements.

Replaces the TPU kernel ``minimal_kernel`` (tools/pallas_probe.py:59,
``pl.pallas_call`` at :70), which exists to prove that the kernel
toolchain runs at all; this one proves Triton's route on the card.  It
is bound by bytes (4 read + 4 written per element): at the probe's
``[256, 256]`` that is 0.5 MB, about 0.16 us at 3.35 TB/s, so the
launch itself dominates.  Design: one program per ``BLOCK`` contiguous
elements, masked at the ragged end; the element count is not
specialized on, so one compiled binary serves every shape.

This module imports ``triton`` at its top: only
``partisan_tpu_torch.kernels.minimal_fn`` imports it, on the card.
"""

import triton
import triton.language as tl


@triton.jit(do_not_specialize=["n_elements"])
def double_kernel(x_ptr, out_ptr, n_elements, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n_elements
    x = tl.load(x_ptr + offs, mask=mask)
    tl.store(out_ptr + offs, x * 2, mask=mask)
