"""Quickstart on the PyTorch port (the twin of examples/quickstart.py):
the paper's core in one page.

Builds the paper's Figure-1 table, computes exact COUNT/SUM/MIN
distributions via PGFs, compares exact vs approximate on a larger table,
and answers a probabilistic threshold query with the PGF ADT.

    PYTHONPATH=src python examples/quickstart_torch.py [--n 50000]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--device`` defaults to the card and raises on a host without one.
Everything runs in float64, as the JAX example does.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core.config import enable_x64, resolve_device

enable_x64()

from repro_torch.core import approx, compare
from repro_torch.core import poisson_binomial as pb
from repro_torch.core.pgf import PGF


def main(argv=None) -> dict:
    """Run the walkthrough; returns the printed quantities."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50_000,
                    help="tuples of the exact-vs-approximate comparison")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    f64 = dict(dtype=torch.float64, device=dev)

    # --- the paper's Figure 1 table: probabilities 0.7, 0.8, 0.5 --------
    probs = torch.tensor([0.7, 0.8, 0.5], **f64)
    values = torch.tensor([3.0, 8.0, 5.0], **f64)

    count = pb.count_pgf(probs).coeffs.cpu().numpy()
    print("COUNT PGF coefficients (X^0..X^3):", np.round(count, 4))
    # paper §IV-A: 0.28X^3 + 0.47X^2 + 0.22X + 0.03

    ssum = pb.sum_pgf(probs, values).coeffs.cpu().numpy()
    nz = {k: round(float(v), 4) for k, v in enumerate(ssum) if v > 1e-12}
    print("SUM distribution:", nz)
    # paper: 0.28X^16 + 0.12X^13 + 0.28X^11 + 0.19X^8 + 0.03X^5 + 0.07X^3 + 0.03

    f1 = PGF.bernoulli(0.7, 3, "MIN", device=dev)
    f2 = PGF.bernoulli(0.8, 8, "MIN", device=dev)
    fmin = f1.mul_min(f2)
    p_min = (float(fmin.mass_at(3)), float(fmin.mass_at(8)),
             float(fmin.p_pos_inf))
    print(f"MIN of first two tuples: P(3)={p_min[0]:.2f} "
          f"P(8)={p_min[1]:.2f} P(undefined)={p_min[2]:.2f}")

    # --- exact vs approximate at scale ----------------------------------
    rng = np.random.default_rng(0)
    n = args.n
    p_big = torch.as_tensor(rng.uniform(0, 1, n), **f64)
    v_big = torch.as_tensor(rng.integers(1, 10, n).astype(float), **f64)

    gm = approx.fit_from_data(p_big, v_big, p=3)       # moment method
    na = approx.fit_normal(p_big, v_big)               # normal
    exact = pb.sum_pgf(p_big, v_big)
    cdf = np.cumsum(exact.coeffs.cpu().numpy())
    s0 = int(gm.mean())
    print(f"\nn={n}: P(SUM <= mean) exact={cdf[s0]:.6f} "
          f"moment={gm.cdf(s0):.6f} normal={na.cdf(s0):.6f}")
    lo_e = float(np.searchsorted(cdf, 0.025))
    lo_g, _ = gm.confidence_interval(0.95)
    print(f".95 CI lower end: exact={lo_e:.0f} moment={lo_g:.1f} "
          f"rel err={abs(lo_g - lo_e) / lo_e:.2e}")

    # --- the PGF ADT answering a query predicate ------------------------
    p_gt = compare.prob_greater(gm, s0 + 500)
    print(f"P(SUM > mean+500) = {p_gt:.4f}  (drives Table I row III "
          f"reweighting, e.g. TPC-H Q20)")
    return dict(count=count, sum=nz, min=p_min, s0=s0,
                exact_cdf=float(cdf[s0]), moment_cdf=float(gm.cdf(s0)),
                normal_cdf=float(na.cdf(s0)), ci_exact=lo_e,
                ci_moment=float(lo_g), p_greater=float(p_gt))


if __name__ == "__main__":
    main()
