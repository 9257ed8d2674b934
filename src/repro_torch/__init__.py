"""PyTorch + CUDA port of the probabilistic-database engine in :mod:`repro`.

The package mirrors :mod:`repro`'s layout (``core/``, ``kernels/``, ``db/``)
and runs the resident single-device TPC-H path on an NVIDIA Hopper card,
with the four CF / cumulant accumulations on hand-written CUDA kernels
(``kernels/csrc``).  It imports neither JAX nor :mod:`repro`.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
card is present.  The CPU runs only when the caller asks for it, and there
every kernel wrapper computes its plain PyTorch version instead.
"""

from .core.config import settle_cpu_math as _settle_cpu_math

_settle_cpu_math()
