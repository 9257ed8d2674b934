"""Serving launcher: batched prefill + decode loop over any assigned
architecture, and the probabilistic-DB query service (the paper's
workload as a server); the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cuda]

    PYTHONPATH=src python -m repro_torch.launch.serve --db --scale 200 \
        --rounds 3 --sweep 64 --cache-capacity 16 [--device cuda]

Without ``--db``, :func:`generate` feeds a random prompt token by token
through ``decode_step`` and then decodes ``--gen`` tokens greedily, on
the arch's reduced config (``--reduced``, on by default, as in the
reference) with random weights; it prints the tokens' shape, the time and
tokens/s.  An embedding-input arch (internvl2, hubert) cannot take its
own generated ids back and is refused.

The ``--db`` loop drives :class:`repro_torch.db.serving.QueryService`:
each round submits every TPC-H serving plan (round 0 lowers and places
cold, later rounds are structural plan-cache hits -- the same bindings,
bit-identical results), then a parameterized Q6 what-if sweep runs
``--sweep`` points through the family's one binding.  It prints
per-round latency, cached queries per second and the service's
hit/miss/eviction counters.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import base as cfgs
from ..core.config import resolve_device
from ..models import api


@torch.no_grad()
def generate(cfg, model, prompt, max_len: int, gen: int):
    """Prefill the prompt token by token into the cache, then decode
    ``gen`` tokens greedily.  prompt: (B, T) token ids on the model's
    device.  Returns the (B, gen) generated ids."""
    if cfg.embedding_inputs:
        raise ValueError(f"{cfg.name} takes embeddings; generated token ids "
                         "cannot be fed back")
    b, t = prompt.shape[:2]
    cache = api.init_cache(cfg, b, max_len, dtype=cfg.torch_dtype,
                           device=prompt.device)
    cl = 0
    logits = None
    for i in range(t):
        logits, cache, cl = api.decode_step(cfg, model, prompt[:, i:i + 1],
                                            cache, cl)
    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for _ in range(gen):
        out.append(tok)
        logits, cache, cl = api.decode_step(cfg, model, tok, cache, cl)
        tok = torch.argmax(logits[:, -1:], dim=-1)
    return torch.cat(out, dim=1)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_db(args) -> int:
    """The ``--db`` service loop: submit / cached hit / evict over the
    TPC-H plan library, then the parameterized Q6 sweep."""
    from ..db import tpch
    from ..db.serving import QueryService

    db = tpch.generate(n_orders=args.scale, device=args.device)
    svc = QueryService(db.tables(), capacity=args.cache_capacity,
                       device=args.device)
    plans = tpch.serving_plans()
    hit_seconds = 0.0
    hit_requests = 0
    for r in range(max(1, args.rounds)):
        _sync(args.device)
        t0 = time.perf_counter()
        hits = 0
        for plan in plans.values():
            _, info = svc.submit(plan)
            hits += int(info["hit"])
        _sync(args.device)
        dt = time.perf_counter() - t0
        if r > 0:                     # warm rounds measure serving QPS
            hit_seconds += dt
            hit_requests += len(plans)
        print(f"[serve-db] round {r}: {len(plans)} queries in {dt:.3f}s "
              f"({hits}/{len(plans)} cache hits)")
    if hit_requests:
        print(f"[serve-db] cached throughput: "
              f"{hit_requests / hit_seconds:.1f} queries/s")
    if args.sweep > 0:
        n = args.sweep
        batch = dict(disc_lo=torch.full((n,), 5, device=args.device),
                     disc_hi=torch.full((n,), 7, device=args.device),
                     qty_lim=torch.arange(1, n + 1, device=args.device))
        _sync(args.device)
        t0 = time.perf_counter()
        _, info = svc.sweep(tpch.q6_family(), batch)
        _sync(args.device)
        print(f"[serve-db] q6 sweep: {info['points']} points in "
              f"{time.perf_counter() - t0:.3f}s")
    print(f"[serve-db] stats: {svc.stats.as_dict()}")
    print(f"[serve-db] plan cache: {svc.cache.info()}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--db", action="store_true",
                    help="serve probabilistic TPC-H queries instead")
    ap.add_argument("--scale", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3,
                    help="request rounds over the plan library (round 0 "
                         "is cold, later rounds hit the cache)")
    ap.add_argument("--sweep", type=int, default=64,
                    help="parameter points of the Q6 what-if sweep (0 "
                         "disables)")
    ap.add_argument("--cache-capacity", type=int, default=16,
                    help="bounded plan-cache entries")
    ap.add_argument("--device", default="cuda",
                    help="where the model or the tables live and run")
    args = ap.parse_args(argv)

    if args.db:
        return serve_db(args)

    cfg = cfgs.get_reduced(args.arch)      # --reduced: always, as upstream
    if cfg.embedding_inputs:
        ap.error(f"--arch {args.arch} takes embeddings; generate feeds "
                 "back token ids")
    dev = resolve_device(args.device)
    model = api.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    _sync(args.device)
    t0 = time.perf_counter()
    toks = generate(cfg, model, prompt, args.prompt_len + args.gen + 1,
                    args.gen)
    _sync(args.device)
    dt = time.perf_counter() - t0
    print(f"[serve] arch={cfg.name} generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
