"""PyTorch + CUDA port of the probabilistic-database engine in :mod:`repro`.

The package mirrors :mod:`repro`'s layout (``core/``, ``kernels/``, ``db/``,
``configs/``, ``models/``, ``train/``, ``launch/``) and runs the
probabilistic-DB engine on an NVIDIA Hopper card, with the CF / cumulant
accumulations and the schoolbook product on hand-written CUDA kernels
(``kernels/csrc``), and the language-model stack through serving and
training (plain PyTorch: the reference has no kernel there, but for the
data sampler's exact batch-size PGF, which runs the ``logcf`` kernel).
It imports neither JAX nor :mod:`repro`.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
card is present.  The CPU runs only when the caller asks for it, and there
every kernel wrapper computes its plain PyTorch version instead.
"""

from .core.config import settle_cpu_math as _settle_cpu_math

_settle_cpu_math()
