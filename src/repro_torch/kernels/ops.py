"""Kernel eligibility guards of the JAX package (port of
``repro.kernels.ops``) and the launch counters of the five kernels.

Whether a kernel is eligible is decided by the guards alone, on any
device: enough tuples to amortise a launch (``MIN_KERNEL_TUPLES``),
float32 probabilities, and for the CF kernels a frequency grid the exact
int32 phase covers (``MAX_KERNEL_FREQ``) and integer values; for the
polynomial product float32 factors of ``MIN_KERNEL_DEGREE`` or more
coefficients.  The UDA
layer applies them and calls the wrappers directly; where an eligible
kernel runs is decided by the tensor's device inside its wrapper: the
CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
"""
from __future__ import annotations

import torch

from . import cumulants as _cum
from . import group_cf as _gcf
from . import group_cumulants as _gcum
from . import pb_cf as _cf
from . import polymul as _pm

# Below these sizes, launch and padding exceed useful work — the UDA's
# blocked loop (tuples) or the plain convolution (coefficients) runs
# instead.
MIN_KERNEL_TUPLES = 256
MIN_KERNEL_DEGREE = 128
# Above this frequency-grid size the CF kernels' int32 split-modmult phase
# would overflow (exact only for num_freq <= 2^20) — the blocked loop runs.
MAX_KERNEL_FREQ = 1 << 20


def cumulant_eligible(probs) -> bool:
    return (probs.shape[0] >= MIN_KERNEL_TUPLES
            and probs.dtype == torch.float32)


def cf_eligible(probs, num_freq: int, values_integral: bool) -> bool:
    return (cumulant_eligible(probs) and num_freq <= MAX_KERNEL_FREQ
            and values_integral)


def polymul_eligible(a, b) -> bool:
    return (min(a.shape[0], b.shape[0]) >= MIN_KERNEL_DEGREE
            and a.dtype == torch.float32 and b.dtype == torch.float32)


#: every kernel wrapper of the port, by kernel name (launch counters).
WRAPPERS = {"logcf": _cf.logcf, "group_logcf": _gcf.group_logcf,
            "cumulant_sums": _cum.cumulant_sums,
            "group_cumulant_sums": _gcum.group_cumulant_sums,
            "polymul": _pm.polymul}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
