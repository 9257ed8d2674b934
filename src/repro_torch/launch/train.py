"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        --reduced --steps 100 --ckpt-dir CKPT [--device cuda]

Trains ``--arch`` (its reduced config with ``--reduced``, else the
published one) on :class:`~repro_torch.train.data.TokenStream` batches
with :class:`~repro_torch.train.trainer.Trainer`: AdamW, ``--accum``
microbatches, a checkpoint every ``--ckpt-every`` steps and at the last,
and a restart from the latest committed checkpoint in ``--ckpt-dir`` (a
directory left from an earlier run resumes it).  ``--device`` defaults to
the card and raises without one; ``--device cpu`` runs the plain
PyTorch path.  Prints ``[train] arch=... loss a -> b over n steps``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import base as cfgs
from ..train.data import TokenStream
from ..train.optimizer import AdamW
from ..train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfgs.get_reduced(args.arch) if args.reduced \
        else cfgs.get_config(args.arch)
    stream = TokenStream(
        cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
        embedding_dim=cfg.d_model if cfg.embedding_inputs else None,
        device=args.device)
    opt = AdamW(lr=args.lr)
    trainer = Trainer(cfg, opt, stream, args.ckpt_dir, accum=args.accum,
                      ckpt_every=args.ckpt_every, device=args.device)
    model, _, hist = trainer.run(args.steps, seed=args.seed)
    n = sum(p.numel() for p in model.parameters())
    if not hist:
        print(f"[train] arch={cfg.name} params={n/1e6:.1f}M: the checkpoint "
              f"in {args.ckpt_dir} is already at step {args.steps}")
        return 0
    print(f"[train] arch={cfg.name} params={n/1e6:.1f}M "
          f"loss {hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
