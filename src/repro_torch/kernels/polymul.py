"""Schoolbook polynomial product (the port of ``repro.kernels.polymul``):
the wrapper of ``csrc/polymul.cu`` and its plain PyTorch version.

    c[t] = sum_u a[u] * b[t - u]          (the linear convolution a * b)

``PGF.mul_sum`` reaches it in its schoolbook branch for float32 factors
of at least ``ops.MIN_KERNEL_DEGREE`` coefficients.
"""
from __future__ import annotations

import torch

from . import build, ref

#: the kernel indexes outputs in int32, a tile (256) past the last one.
MAX_OUTPUT = (1 << 31) - 1 - 512


def polymul_plain(a, b):
    """The plain PyTorch version: a loop over the shorter factor."""
    return ref.polymul_ref(a, b)


def polymul(a, b):
    """Linear convolution of two 1-D coefficient vectors, (na + nb - 1,).
    A CUDA tensor launches ``csrc/polymul.cu`` (float32 only); a CPU tensor
    computes :func:`polymul_plain`."""
    if a.device.type == "cpu":
        return polymul_plain(a, b)
    na, nb = a.shape[0], b.shape[0]
    if na < 1 or nb < 1:
        raise ValueError(f"polymul: empty factor ({na}, {nb})")
    nc = na + nb - 1
    if nc > MAX_OUTPUT:
        raise ValueError(f"polymul: output length {nc} exceeds the kernel's "
                         f"int32 indexing ({MAX_OUTPUT})")
    build.check_operand("polymul a", a, torch.float32)
    build.check_operand("polymul b", b, torch.float32)
    if b.device != a.device:
        raise ValueError(f"polymul: factors on {a.device} and {b.device}")
    c = torch.empty((nc,), dtype=torch.float32, device=a.device)
    build.launch("polymul_launch", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 na, nb, build.stream_handle(a.device))
    polymul.launches += 1
    return c


polymul.launches = 0
