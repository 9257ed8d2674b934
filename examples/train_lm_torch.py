"""End-to-end training driver on the PyTorch port (the twin of
examples/train_lm.py): a ~100M-param yi-family model for a few hundred
steps with the port's training substrate -- the PGF-sized probabilistic
sampler, microbatch accumulation, checkpoint-restart (a failure is
injected mid-run and the loop resumes from the latest checkpoint) -- and
the loss falling.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
    PYTHONPATH=src python examples/train_lm_torch.py --small --device cpu

``--device`` defaults to the card and raises on a host without one;
``--small`` is a 2-layer model that trains in seconds on the CPU.
"""
import argparse
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.train.data import ProbabilisticSampler, TokenStream
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import Trainer, run_with_failures


def config(small: bool) -> ModelConfig:
    if small:
        return ModelConfig(
            name="yi_tiny", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=352, vocab_size=2048,
            mlp="swiglu", dtype="float32")
    # ~100M params: 12L x 768, llama/yi family
    return ModelConfig(
        name="yi_100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000,
        mlp="swiglu", dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="default 200 (60 with --small)")
    ap.add_argument("--small", action="store_true",
                    help="tiny model, 60 steps of 64 tokens (seconds on "
                         "the CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="default 256 (64 with --small)")
    ap.add_argument("--pool", type=int, default=512,
                    help="examples the sampler draws a batch from")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.steps is None:
        args.steps = 60 if args.small else 200
    if args.seq is None:
        args.seq = 64 if args.small else 256

    cfg = config(args.small)
    print(f"arch={cfg.name}: ~{cfg.param_count() / 1e6:.0f}M params, "
          f"{args.steps} steps of batch {args.batch} x seq {args.seq} on "
          f"{args.device}")

    # PGF-backed probabilistic sampling (the paper as substrate): each
    # example carries an inclusion probability; the exact Poisson-binomial
    # PGF of the batch size sizes the padded batch capacity (in float32 on
    # the card a pool of 256 to 8,191 examples runs the logcf kernel).
    rng = np.random.default_rng(0)
    sampler = ProbabilisticSampler(rng.uniform(0.5, 0.95, args.pool),
                                   device=args.device)
    f = sampler.batch_size_pgf()
    print(f"probabilistic sampler: pool={args.pool} "
          f"E[batch]={float(f.mean()):.1f} "
          f"capacity(1e-3)={sampler.capacity_for(1e-3)} "
          f"step-0 draw={int(sampler.draw(0).sum())}")

    stream = TokenStream(cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=0, device=args.device)
    opt = AdamW(lr=6e-4, warmup=40)
    with tempfile.TemporaryDirectory() as ckdir:
        trainer = Trainer(cfg, opt, stream, ckdir, accum=2,
                          ckpt_every=max(20, args.steps // 4),
                          device=args.device)
        fail_step = args.steps // 2
        print(f"injecting a node failure at step {fail_step} "
              f"(restart from the latest checkpoint)...")
        t0 = time.time()
        _, _, hist, attempts = run_with_failures(trainer, args.steps,
                                                 {fail_step})
        dt = time.time() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"done in {dt:.1f}s over {attempts} attempts "
          f"({tokens / dt:.0f} tok/s on {args.device}, checkpoints "
          f"included)")
    print(f"loss after the restart: {hist[0]:.4f} -> {hist[-1]:.4f} "
          f"(ppl {np.exp(hist[0]):.1f} -> {np.exp(hist[-1]):.1f})")
    if not hist[-1] < hist[0]:
        raise SystemExit("training must reduce the loss")


if __name__ == "__main__":
    main()
