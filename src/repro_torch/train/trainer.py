"""Training loop: microbatch accumulation, checkpoint-restart, failure
injection, deterministic restart (the port of ``repro.train.trainer``).

:func:`make_train_step` builds the step for any ModelConfig:

    step(model, opt_state, batch) -> metrics

which updates the model's parameters and ``opt_state`` in place: the
gradients of :func:`repro_torch.models.api.loss_fn` (per-period remat),
accumulated over ``accum`` microbatches, clipped by their global norm,
then the AdamW update.  :class:`Trainer` drives it with
checkpoint-every-N and restart-from-latest semantics;
:func:`run_with_failures` kills the loop at chosen steps and restarts it,
and its final parameters equal an uninterrupted run's bit for bit.

Given a :class:`repro_torch.sharding.ShardedModel` (the parameters
placed by a ``Rules`` table on a mesh of ranks; every rank calls the step
with the same global batch), the same step runs sharded: each
microbatch's rows are split over the data axes, every rank runs
``loss_fn`` on its rows with each segment's parameters gathered from the
blocks just before it runs (``ShardedModel.gathered``), each segment's
gradients are reduced to the rank's blocks (the mean over the data axes)
when its backward ends, the clip reads the global norm, and AdamW
updates each rank's blocks.  Loss, grad
norm and parameters equal the one-rank step's up to float rounding (the
rows' sums run in another order); a rerun on the same mesh gives the same
bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from .. import sharding
from ..core.config import resolve_device
from ..models import api
from . import checkpoint as ckpt_lib
from .optimizer import AdamW, AdamWState, clip_by_global_norm


def make_train_step(cfg, opt: AdamW, *, accum: int = 1, remat: bool = True,
                    clip: float = 1.0, accum_dtype=torch.float32):
    """The train step with ``accum`` microbatches per step.

    The microbatches run as a Python loop: each one's gradients are added,
    as ``(g.float() / accum).to(accum_dtype)``, into accumulators of
    ``accum_dtype`` (bf16 for a memory gate), as the reference's scanned
    ``micro`` adds them.  With ``accum=1`` the gradients stay in the
    parameters' dtype, as the reference's do.  The reference's ``donate``
    and ``jit`` have no counterpart: the step updates in place, so there
    is no second copy to donate, and it runs eagerly.
    """

    def step(model, opt_state: AdamWState, batch) -> dict:
        if isinstance(model, sharding.ShardedModel):
            with model.rules.activate():
                return sharded_step(model, opt_state, batch)
        if sharding.current_rules() is not None:
            raise ValueError("under Rules.activate() the step takes a "
                             "sharding.ShardedModel")
        tokens, labels = batch["tokens"], batch["labels"]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum > 1:
            mb = tokens.shape[0] // accum
            dev = tokens.device
            div = torch.full((), accum, dtype=torch.float32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                sl = slice(i * mb, (i + 1) * mb)
                l, _ = api.loss_fn(cfg, model, tokens[sl], labels[sl],
                                   remat=remat)
                l.backward()
                with torch.no_grad():
                    for k, p in params.items():
                        grads[k] += (p.grad.float() / div).to(accum_dtype)
                        p.grad = None
                loss = loss + l.detach() / div
        else:
            l, _ = api.loss_fn(cfg, model, tokens, labels, remat=remat)
            l.backward()
            loss = l.detach()
            grads = {k: p.grad for k, p in params.items()}
        grads, gnorm = clip_by_global_norm(grads, clip)
        opt.update(grads, opt_state, params)
        for p in params.values():
            p.grad = None
        return dict(loss=loss, grad_norm=gnorm)

    def sharded_step(model, opt_state, batch) -> dict:
        """The step on a mesh (module docstring): microbatch ``i`` is the
        global rows ``[i * mb, (i + 1) * mb)``, as the reference reshapes
        the batch, each split over the data axes."""
        tokens, labels = batch["tokens"], batch["labels"]

        def micro(tok, lab, convert):
            """(the global mean loss, this rank's gradient blocks, each
            passed through ``convert`` as its segment's backward ends)."""
            place = functools.partial(sharding.place_batch, model.rules)
            model.grad_convert = convert
            try:
                l, _ = api.loss_fn(cfg, model.work, place(tok), place(lab),
                                   remat=remat, gather=model.gathered)
                l.backward()
                return model.mean_over_dp(l), model.take_grads()
            finally:
                model.grad_convert = None

        if accum > 1:
            mb = tokens.shape[0] // accum
            div = torch.full((), accum, dtype=torch.float32,
                             device=tokens.device)
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device)
                     for k, p in model.params.items()}

            def add(k, v):
                return grads[k].add_((v / div).to(accum_dtype))
            loss = torch.zeros_like(div)
            for i in range(accum):
                sl = slice(i * mb, (i + 1) * mb)
                l, _ = micro(tokens[sl], labels[sl], add)
                loss = loss + l / div
        else:
            loss, grads = micro(tokens, labels, lambda k, v: v.to(
                model.params[k].dtype))
        grads, gnorm = clip_by_global_norm(grads, clip,
                                           model.global_norm(grads))
        opt.update(grads, opt_state, model.params)
        return dict(loss=loss, grad_norm=gnorm)

    return step


@dataclasses.dataclass
class Trainer:
    cfg: Any
    opt: AdamW
    stream: Any                          # train.data.TokenStream
    ckpt_dir: str
    accum: int = 1
    ckpt_every: int = 50
    remat: bool = True
    device: str = "cuda"

    def __post_init__(self):
        self.step_fn = make_train_step(self.cfg, self.opt, accum=self.accum,
                                       remat=self.remat)

    def init_state(self, seed: int = 0):
        """A fresh model (the reference's initialisers, drawn from a
        generator seeded with ``seed`` on the device) and its optimizer
        state."""
        dev = resolve_device(self.device)
        model = api.init_params(self.cfg,
                                torch.Generator(dev).manual_seed(seed), dev)
        return model, self.opt.init(model)

    def restore_or_init(self, seed: int = 0):
        """(model, opt_state, step): the latest committed checkpoint, or a
        fresh state at step 0."""
        last = ckpt_lib.latest_step(self.ckpt_dir)
        model, opt_state = self.init_state(seed)
        if last is None:
            return model, opt_state, 0
        params = dict(model.named_parameters())
        like = {"params": params, "opt": opt_state.tree()}
        tree, manifest = ckpt_lib.restore(self.ckpt_dir, last, like)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(tree["params"][k])
        opt_state.load_(tree["opt"])
        return model, opt_state, int(manifest["step"])

    def run(self, num_steps: int, *, seed: int = 0,
            fail_at: Callable[[int], bool] | None = None):
        """Train to ``num_steps`` global steps, restarting from the latest
        checkpoint.  ``fail_at(step)`` True simulates a node failure
        (raises after the optimizer update, before the checkpoint -- the
        worst-case crash point).  Returns (model, opt_state, losses of the
        steps this call ran)."""
        model, opt_state, start = self.restore_or_init(seed)
        dev = resolve_device(self.device)
        history = []
        for step in range(start, num_steps):
            batch = {k: v.to(dev) for k, v in self.stream.batch(step).items()}
            metrics = self.step_fn(model, opt_state, batch)
            history.append(float(metrics["loss"]))
            done = step + 1
            if done % self.ckpt_every == 0 or done == num_steps:
                ckpt_lib.save(self.ckpt_dir, done,
                              {"params": dict(model.named_parameters()),
                               "opt": opt_state.tree()},
                              extra={"loss": history[-1]})
            if fail_at is not None and fail_at(step):
                raise RuntimeError(f"injected failure at step {step}")
        return model, opt_state, history


def run_with_failures(trainer: Trainer, num_steps: int,
                      fail_steps: set[int], seed: int = 0):
    """Drive ``trainer`` to completion across injected failures -- the
    checkpoint-restart harness.  Each step in ``fail_steps`` kills the
    loop once; the loop restarts from the latest checkpoint.  Returns
    (model, opt_state, history, attempts)."""
    fired: set[int] = set()

    def fail_at(s: int) -> bool:
        if s in fail_steps and s not in fired:
            fired.add(s)
            return True
        return False

    attempts = 0
    while True:
        attempts += 1
        try:
            model, opt_state, hist = trainer.run(num_steps, seed=seed,
                                                 fail_at=fail_at)
            return model, opt_state, hist, attempts
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
