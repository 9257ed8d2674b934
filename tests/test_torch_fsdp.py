"""Per-period parameter and cache gathers of ``sharding.ShardedModel``,
on four gloo ranks, CPU, float32 (no JAX: the port against itself).

* **The step's bits.**  On (2, 2) and (4, 1), two steps of the sharded
  ``make_train_step`` (remat on; accum 1 and 2) leave blocks, moments,
  losses and grad norms bit-equal to the whole-gather algorithm the
  sharded step ran before the gathers went per period, rebuilt here from
  public pieces (:func:`_whole_gather_step`): every parameter gathered
  whole into a real model (``NamedSharding.gather``), the rank's rows run,
  every gradient reduced with ``NamedSharding.reduce``, the same clip and
  update.  Reduced yi_6b (a dense transformer) and olmoe_1b_7b (experts
  over the model axis on (2, 2)).
* **Memory.**  The live bytes a step allocates (the dry-run's tracker,
  ``launch/dryrun.py`` ``LiveBytes``) stay under the reduced gradient
  blocks + 3 x (the largest segment's whole parameters + the embedding,
  final norm and head) + the activations of the rank's rows (the same
  tracker on a plain one-rank model's forward and backward, less its
  whole gradients), and under the whole-gather step's: a six-layer yi_6b,
  so that one period is a sixth of the layers.  The factor 3 is the
  gather's own transients (the block moved to the front, the gathered
  tensor, moved back).
* **Decode.**  The sharded ``decode_step`` (a cache of blocks under
  ``sharding.cache_shardings``) gives the logits of one rank's
  ``decode_step`` within ``ATOL`` (tests/test_torch_models.py's float32
  bound) over a prompt and three steps, and its gathered cache equals the
  one-rank cache within the same bound: yi_6b (KV heads over the model
  axis where they divide it), recurrentgemma_2b (rglru state, local
  attention, two tail layers), rwkv6_1b6 (recurrent state).

One spawn of 4 ranks for the file.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch import sharding
from repro_torch.models import api
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.optimizer import AdamW, clip_by_global_norm
from repro_torch.train.trainer import make_train_step

SHAPES = ((2, 2), (4, 1))
STEP_CASES = [(arch, accum) for arch in ("yi_6b", "olmoe_1b_7b")
              for accum in (1, 2)]
DECODE_ARCHS = ("yi_6b", "recurrentgemma_2b", "rwkv6_1b6")
BATCH = (8, 16)
STEPS = 2
ATOL = 5e-5
OPT = dict(lr=3e-5, warmup=1)


def _model(cfg, seed=0):
    return api.init_params(cfg, torch.Generator("cpu").manual_seed(seed),
                           "cpu")


def _batches(cfg, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, BATCH)
                                 .astype(np.int32))
             for k in ("tokens", "labels")} for _ in range(n)]


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), backend="gloo", device="cpu")


# ------------------------------------------------- the whole-gather step
def _block_model(cfg, sm):
    """A real model whose parameters are the shapes the sharded step
    computes on: the model-axis block of each one ``sm.split`` names (its
    layers compute on that block), the whole tensor of the rest."""
    dp = sharding._dp_axes(sm.rules.mesh)
    work = _model(cfg)
    for name in sm.split:
        mname, attr = name.rsplit(".", 1) if "." in name else ("", name)
        mod = work.get_submodule(mname)
        old = mod._parameters[attr]
        sl = sm.shardings[name].block(old.shape, skip=dp)
        mod._parameters[attr] = torch.nn.Parameter(old.detach()[sl].clone())
    return work


def _whole_gather_step(cfg, opt, sm, work, accum: int):
    """The sharded step with every parameter gathered up front over the
    data axes into the block its layer computes on: ``work``
    (:func:`_block_model`) takes the gathered tensors (the model-axis
    block of a parameter in ``sm.split``, the whole tensor of the rest),
    runs the rank's rows, and each ``.grad`` is reduced by
    ``NamedSharding.reduce``; ``sm`` lends its blocks, shardings and
    global norm."""

    def step(state, batch):
        with torch.no_grad():
            for name, p in work.named_parameters():
                sh = sm.shardings[name]
                p.copy_(sh.gather(sm.params[name],
                                  skip=sm.split.get(name, ())))

        def micro(tok, lab):
            place = lambda x: sharding.place_batch(sm.rules, x)  # noqa
            loss, _ = api.loss_fn(cfg, work, place(tok), place(lab),
                                  remat=True)
            loss.backward()
            grads = {}
            for name, p in work.named_parameters():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads[name] = sm.shardings[name].reduce(
                    g, skip=sm.split.get(name, ()))
                p.grad = None
            return sm.mean_over_dp(loss), grads

        tokens, labels = batch["tokens"], batch["labels"]
        with sm.rules.activate():
            if accum > 1:
                mb = tokens.shape[0] // accum
                div = torch.full((), accum, dtype=torch.float32)
                grads = {k: torch.zeros(p.shape, dtype=torch.float32)
                         for k, p in sm.params.items()}
                loss = torch.zeros_like(div)
                for i in range(accum):
                    sl = slice(i * mb, (i + 1) * mb)
                    l, g = micro(tokens[sl], labels[sl])
                    with torch.no_grad():
                        for k, v in g.items():
                            grads[k] += (v / div).to(torch.float32)
                    loss = loss + l / div
            else:
                loss, g = micro(tokens, labels)
                grads = {k: v.to(sm.params[k].dtype) for k, v in g.items()}
            grads, gnorm = clip_by_global_norm(grads, 1.0,
                                               sm.global_norm(grads))
            opt.update(grads, state, sm.params)
        return dict(loss=loss, grad_norm=gnorm)
    return step


def _step_case(arch, accum, shape):
    """(bit-equal blocks, moments and metrics, per-step losses)."""
    cfg = C.get_reduced(arch)
    mesh = _mesh(shape)
    rules = sharding.Rules(mesh, fsdp=True)
    opt = AdamW(**OPT)
    new = sharding.ShardedModel(_model(cfg), rules)
    new_state = opt.init(new)
    old = sharding.ShardedModel(_model(cfg), rules)
    old_state = opt.init(old)
    work = _block_model(cfg, old)
    step = make_train_step(cfg, opt, accum=accum, remat=True)
    ref_step = _whole_gather_step(cfg, opt, old, work, accum)
    same, losses = True, []
    for b in _batches(cfg):
        with rules.activate():
            m = step(new, new_state, b)
        r = ref_step(old_state, b)
        same &= float(m["loss"]) == float(r["loss"]) \
            and float(m["grad_norm"]) == float(r["grad_norm"])
        losses.append(float(m["loss"]))
    same &= all(torch.equal(new.params[n], old.params[n])
                and torch.equal(new_state.mu[n], old_state.mu[n])
                and torch.equal(new_state.nu[n], old_state.nu[n])
                for n in new.params)
    return same, losses


# ----------------------------------------------------------------- memory
def _peak_case():
    """(the step's in-step peak, the whole-gather step's, the bound)."""
    from repro_torch.launch.dryrun import LiveBytes
    cfg = dataclasses.replace(C.get_reduced("yi_6b"), n_layers=6)
    rules = sharding.Rules(_mesh((2, 2)), fsdp=True)
    opt = AdamW(**OPT)
    batch = _batches(cfg, 1)[0]
    sm = sharding.ShardedModel(_model(cfg), rules)
    state = opt.init(sm)
    step = make_train_step(cfg, opt, remat=True)
    with rules.activate(), LiveBytes() as new:
        step(sm, state, batch)
    old = sharding.ShardedModel(_model(cfg), rules)
    old_state = opt.init(old)
    work = _block_model(cfg, old)
    ref = _whole_gather_step(cfg, opt, old, work, 1)
    with LiveBytes() as whole:
        ref(old_state, batch)

    def nbytes(t):
        return t.numel() * t.element_size()
    one = _model(cfg)
    place = lambda x: sharding.place_batch(rules, x)  # noqa: E731
    with LiveBytes() as act:
        loss, _ = api.loss_fn(cfg, one, place(batch["tokens"]),
                              place(batch["labels"]), remat=True)
        loss.backward()
    grads_whole = sum(nbytes(p) for p in one.parameters())
    segs = max(sum(nbytes(p) for p in seg.parameters())
               for seg in one.segments())
    ends = sum(nbytes(p) for m in (one.embed, one.final_norm, one.head)
               for p in m.parameters())
    blocks_f32 = sum(t.numel() * 4 for t in sm.params.values())
    bound = blocks_f32 + 3 * (segs + ends) + (act.peak - grads_whole)
    return new.peak, whole.peak, bound


# ----------------------------------------------------------------- decode
def _decode_case(arch, shape, steps=3, prompt=4):
    """(max |logits - one rank's| over the steps, max |cache - one
    rank's|) on ``shape``."""
    cfg = C.get_reduced(arch)
    model = _model(cfg)
    rules = sharding.Rules(_mesh(shape), fsdp=True)
    sm = sharding.ShardedModel(_model(cfg), rules)
    b, max_len = BATCH[0], prompt + steps
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (b, prompt + steps)).astype(np.int64))
    cache = api.init_cache(cfg, b, max_len, dtype=torch.float32,
                           device="cpu")
    blocks = sm.init_cache(b, max_len, dtype=torch.float32)
    err = 0.0
    for t in range(prompt + steps):
        tok = toks[:, t:t + 1]
        want, cache, _ = api.decode_step(cfg, model, tok, cache, t)
        got, blocks, _ = api.decode_step(cfg, sm, tok, blocks, t)
        err = max(err, float((got - want).abs().max()))

    def gather(node):
        if isinstance(node, dict):
            return {k: gather(v) for k, v in node.items()}
        return node.full()

    def diff(a, b):
        if isinstance(a, dict):
            return max(diff(a[k], b[k]) for k in a)
        return float((a.float() - b.float()).abs().max())
    return err, diff(gather(blocks), cache)


def _rank():
    out = {"steps": {}, "decode": {}}
    for shape in SHAPES:
        for arch, accum in STEP_CASES:
            out["steps"][(arch, accum, shape)] = _step_case(arch, accum,
                                                            shape)
        for arch in DECODE_ARCHS:
            out["decode"][(arch, shape)] = _decode_case(arch, shape)
    out["peak"] = _peak_case()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_rank, 4, backend="gloo", device="cpu",
                     store_dir=tmp_path_factory.mktemp("fsdp") / "store",
                     timeout=300)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch,accum", STEP_CASES)
def test_step_bit_equal_to_whole_gather(ranks, arch, accum, shape):
    for r in ranks:
        same, losses = r["steps"][(arch, accum, shape)]
        assert same, (arch, accum, shape)
        assert losses == ranks[0]["steps"][(arch, accum, shape)][1]


def test_step_peak_under_one_period(ranks):
    """Every rank's in-step peak under the bound (module docstring) and
    under the whole-gather step's peak."""
    for r in ranks:
        new, whole, bound = r["peak"]
        assert new <= bound, (new, bound)
        assert new < whole, (new, whole)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_matches_one_rank(ranks, arch, shape):
    for r in ranks:
        logits_err, cache_err = r["decode"][(arch, shape)]
        assert logits_err <= ATOL, logits_err
        assert cache_err <= ATOL, cache_err
