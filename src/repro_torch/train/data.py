"""Deterministic, shardable data pipeline + the paper's PGF tie-in (the
port of ``repro.train.data``).

:class:`TokenStream` produces synthetic LM batches keyed only by (seed,
step, shard): any process can regenerate any shard of any step, so a
restart at step k needs no data-state file.  The draws come from a CPU
``torch.Generator`` seeded by a hash of the key, so a batch has the same
bits on every device and in every process; they are not
``jax.random``'s bits (the reference's stream is a different generator),
only as deterministic and as disjoint across shards.

:class:`ProbabilisticSampler` is the paper as substrate: each example
carries an inclusion probability p_i (the tuple-independence model applied
to a training corpus), and the port's exact Poisson-binomial COUNT
(:func:`repro_torch.core.poisson_binomial.count_pgf`, paper Eq. 4) gives
the distribution of the effective batch size -- used to pick a padded
batch capacity with overflow probability < eps.  It runs in the port's
default float, as the reference runs in float64 only with x64 on: in
float32 on the card, a pool of 256 to 8,191 examples takes the ``logcf``
CUDA kernel (one launch; larger pools take the FFT product tree).  A
float32 PGF places a tail probability only to ~1e-4 at 4,096 examples
(the CPU's plain version, 50-95% inclusion: its cumulative sum errs by
9.7e-5 near the capacities), so there a capacity for eps = 1e-4 comes out
3,058 where float64 gives 3,063, and for 1e-6 3,063 against 3,091.  Call
:func:`repro_torch.core.config.enable_x64` for capacities at small eps
(float64 takes no kernel).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..core import poisson_binomial as pb
from ..core.config import default_float, resolve_device


def key_generator(*parts: int) -> torch.Generator:
    """A CPU generator seeded by a 63-bit hash of the integers ``parts``:
    the same key gives the same draws in every process."""
    h = hashlib.blake2b(np.asarray(parts, dtype=np.int64).tobytes(),
                        digest_size=8)
    return torch.Generator().manual_seed(
        int.from_bytes(h.digest(), "little") >> 1)


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embedding_dim: int | None = None   # [vlm]/[audio]: emit embeddings
    device: str = "cuda"

    def batch(self, step: int, shard: int = 0, num_shards: int = 1):
        """The (step, shard)-th batch slice on ``device``; deterministic,
        stateless."""
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {num_shards} shards")
        dev = resolve_device(self.device)
        b = self.global_batch // num_shards
        gen = key_generator(self.seed, step, shard)
        if self.embedding_dim:
            tokens = torch.randn((b, self.seq_len, self.embedding_dim),
                                 generator=gen, dtype=torch.float32)
        else:
            tokens = torch.randint(0, self.vocab_size, (b, self.seq_len),
                                   generator=gen, dtype=torch.int32)
        labels = torch.randint(0, self.vocab_size, (b, self.seq_len),
                               generator=gen, dtype=torch.int32)
        return dict(tokens=tokens.to(dev), labels=labels.to(dev))


def capacity_from(coeffs, eps: float) -> int:
    """The reference's searchsorted rule on a COUNT PGF's coefficients:
    the first index whose cumulative sum (in float64 on the host) reaches
    1 - eps, plus one, at most the coefficient count."""
    cdf = np.cumsum(coeffs.double().cpu().numpy())
    idx = int(np.searchsorted(cdf, 1.0 - eps))
    return min(idx + 1, len(cdf))


@dataclasses.dataclass
class ProbabilisticSampler:
    """Tuple-independent example inclusion; exact batch-size PGF."""

    inclusion_probs: np.ndarray        # (pool,) example inclusion probs
    seed: int = 0
    device: str = "cuda"

    def probs(self) -> torch.Tensor:
        """The inclusion probabilities in the default float on
        ``device``."""
        return torch.as_tensor(np.asarray(self.inclusion_probs),
                               dtype=default_float(),
                               device=resolve_device(self.device))

    def batch_size_pgf(self):
        """Exact Poisson-binomial distribution of #included examples."""
        return pb.count_pgf(self.probs())

    def capacity_for(self, eps: float = 1e-6) -> int:
        """Smallest capacity C with P(#included > C) < eps -- the PGF
        ADT's GreaterEq answering a systems question exactly."""
        return capacity_from(self.batch_size_pgf().coeffs, eps)

    def draw(self, step: int) -> np.ndarray:
        """Bernoulli world at this step (the 'random instance' of Fig. 2),
        from a generator keyed by (seed, step)."""
        u = torch.rand(len(self.inclusion_probs), dtype=torch.float64,
                       generator=key_generator(self.seed, step)).numpy()
        return u < np.asarray(self.inclusion_probs)
