"""Tensor- and sequence-parallel compute on the model axis, on gloo ranks,
CPU, float32: each rank of a model row computes its share of the layers
the rules split (``sharding.py``'s module docstring).

Ranks are spawned once for 2 ranks and once for 4, side by side from
threads, while the JAX references compile in this process.  Reduced
yi_6b (GQA; on a model axis of 4 its 2 KV heads are repeated to 4),
granite_34b (MQA: its one KV head repeated to the model axis),
recurrentgemma_2b with 2 query heads (RG-LRU width split, local attention;
the reduced config's 4 heads divide every model axis here, 2 heads leave
a model axis of 4 to the query-time split), rwkv6_1b6 (head-split WKV),
olmoe_1b_7b (attention heads split, experts as before) and yi_6b with
``Rules(sp=True)`` (the residual split on ``d_model`` between sublayers)
run on meshes (1, 2), (2, 2) and (1, 4):

* two train steps against the JAX package's unsharded jitted step on the
  same numpy batches and against the port's one-rank step (rank 0): loss
  and grad norm within ``RTOL``, every step's gradients (what the
  optimizer is handed, recorded) within ``GRAD_RTOL`` of each leaf's
  scale, every updated parameter within ``PARAM_TOL`` of its leaf's scale
  with the elements whose reference gradient sits at Adam's eps left out
  (tests/test_torch_mesh_train.py's bounds, rule and lr: its docstring).
  The gradients are what holds the split's backward: a block of a
  gradient from the wrong rank moves a leaf's error to order one, while
  an Adam step moves every element by about lr, whatever its gradient;
* prefill, and a decode of a prompt and three steps, against one rank's
  within ``ATOL`` (tests/test_torch_fsdp.py's): the decode runs on
  KV heads split over the model axis (yi_6b on (1, 2)) and on a
  sequence-split cache (granite_34b, recurrentgemma_2b, yi_6b on
  (1, 4));
* the recorded first fit is the one the reference's own attention code
  chooses (its KV-head repeat included) on the same mesh;
* the split log-sum-exp against ``torch.logsumexp``; a rank's FLOPs on
  (1, 2) (``launch/dryrun.py``'s counter) against one rank's.

The JAX package is imported inside functions only: the ranks import this
module.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch import sharding
from repro_torch.models import api, convert
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step
from test_torch_fsdp import ATOL
from test_torch_mesh_train import (FAST_COMPILE, OPT, PARAM_TOL, RTOL,
                                   Recording, _grads_close, _jax_steps,
                                   _metrics_close, _param_err,
                                   _params_close)

ARCHS = ("yi_6b", "granite_34b", "recurrentgemma_2b", "rwkv6_1b6",
         "olmoe_1b_7b")
#: (arch, sp)
CASES = [(a, False) for a in ARCHS] + [("yi_6b", True)]
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
#: query heads replaced in the reduced config (both packages)
HEADS = {"recurrentgemma_2b": 2}
STEPS = 2
BATCH = (4, 16)
PROMPT, DECODE = 5, 3
LSE_RTOL = 1e-6
FLOPS_SHARE = 0.6


def _cfg(arch):
    cfg = C.get_reduced(arch)
    return dataclasses.replace(cfg, n_heads=HEADS[arch]) if arch in HEADS \
        else cfg


def _jcfg(arch):
    from repro.configs import get_reduced
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, n_heads=HEADS[arch]) if arch in HEADS \
        else cfg


def _batches(arch, seed=0):
    rng = np.random.default_rng(seed)
    v = _cfg(arch).vocab_size
    return [{k: rng.integers(0, v, BATCH).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------- the ranks
def _step(cfg, model, batches):
    """(metrics, the gradients each step handed the optimizer: this
    rank's blocks on a mesh)."""
    opt = Recording(**OPT)
    state = opt.init(model)
    step = make_train_step(cfg, opt, remat=True)
    return [{k: float(v) for k, v in step(model, state,
                                          _torch_batch(b)).items()}
            for b in batches], opt.seen


def _one_rank(arch, params, batches):
    cfg = _cfg(arch)
    model = convert.from_reference(cfg, params, device="cpu")
    metrics, grads = _step(cfg, model, batches)
    return dict(metrics=metrics, grads=grads,
                params={k: v.detach().clone()
                        for k, v in model.named_parameters()})


def _sharded(cfg, params, shape, sp=False):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
    rules = sharding.Rules(mesh, fsdp=True, sp=sp)
    return sharding.ShardedModel(
        convert.from_reference(cfg, params, device="cpu"), rules)


def _serving(cfg, params, shape, sp, tokens):
    """(prefill's max |err|, decode's max |err| over the prompt and the
    steps, the model-split dim of the first attention cache leaf) against
    one rank's."""
    one = convert.from_reference(cfg, params, device="cpu")
    sm = _sharded(cfg, params, shape, sp)
    with sm.rules.activate():
        got = api.prefill(cfg, sm, tokens)
    pre = float((got - api.prefill(cfg, one, tokens)).abs().max())
    b, n = tokens.shape
    cache = api.init_cache(cfg, b, n, dtype=torch.float32, device="cpu")
    blocks = sm.init_cache(b, n, dtype=torch.float32)
    dec = 0.0
    for t in range(n):
        tok = tokens[:, t:t + 1]
        want, cache, _ = api.decode_step(cfg, one, tok, cache, t)
        got, blocks, _ = api.decode_step(cfg, sm, tok, blocks, t)
        dec = max(dec, float((got - want).abs().max()))
    split = None
    for j, kind in enumerate(cfg.pattern):
        if kind.startswith("attn"):
            spec = blocks[str(j)]["k"].sharding.spec
            split = next((i for i, e in enumerate(spec) if e == "model"),
                         None)
            break
    return pre, dec, split


def _case(arch, sp, shape, params, batches, rank):
    cfg = _cfg(arch)
    sm = _sharded(cfg, params, shape, sp)
    sharding.reset_collective_bytes()
    with sm.rules.activate():
        metrics, seen = _step(cfg, sm, batches)
    tp = sharding.COLLECTIVE_BYTES.get("tp", 0)
    full = {n: sm.shardings[n].gather(t) for n, t in sm.params.items()}
    grads = [{n: sm.shardings[n].gather(g) for n, g in s.items()}
             for s in seen]
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (BATCH[0], PROMPT + DECODE)).astype(np.int64))
    pre, dec, split = _serving(cfg, params, shape, sp, tokens)
    return dict(metrics=metrics, first_fit=sm.rules.layouts.get("first_fit"),
                params=full if rank == 0 else None,
                grads=grads if rank == 0 else None, tp=tp,
                split=sorted(sm.split), prefill=pre, decode=dec,
                cache_split=split)


def _flops(params, batches, shape):
    """The FLOPs of one step of yi_6b, counted by the dry-run's counter:
    on ``shape`` (this rank's) or one rank (None)."""
    from repro_torch.launch.dryrun import LiveBytes
    cfg = _cfg("yi_6b")
    if shape is None:
        model, rules = convert.from_reference(cfg, params, device="cpu"), None
    else:
        model = _sharded(cfg, params, shape)
        rules = model.rules
    opt = AdamW(**OPT)
    state = opt.init(model)
    step = make_train_step(cfg, opt, remat=True)
    with LiveBytes() as live:
        if rules is None:
            step(model, state, _torch_batch(batches[0]))
        else:
            with rules.activate():
                step(model, state, _torch_batch(batches[0]))
    return live.flops


def _tp_sum():
    """The model axis's sum over (1, 4) (``sharding.tp_sum``, a
    sum-scatter and a gather) against the ordered sum of every rank's
    whole tensor (``sharding.sum_over``) on seeded float32 parts, one a
    rank: (bits equal, tp_sum's bytes received, sum_over's, the part's
    bytes)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 4), ("data", "model"), backend="gloo", device="cpu")
    ax = mesh.axis("model")
    x = torch.from_numpy(np.random.default_rng(3 + ax.index).normal(
        0, 1, (3, 8, 5)).astype(np.float32))
    got_bytes = []
    outs = []
    for fn in (lambda: sharding.tp_sum(x, ax),
               lambda: sharding.sum_over(x, ax, "tp")):
        sharding.reset_collective_bytes()
        outs.append(fn())
        got_bytes.append(sharding.COLLECTIVE_BYTES["tp"])
    return (torch.equal(*outs), *got_bytes, x.numel() * 4)


def _lse():
    """Relative error of the split log-sum-exp against torch.logsumexp
    on this rank's vocabulary block of seeded float32 logits."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"), backend="gloo", device="cpu")
    ax = mesh.axis("model")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 8, (3, 5, 64)).astype(np.float32))
    n = x.shape[-1] // ax.size
    got = sharding.split_logsumexp(x[..., ax.index * n:(ax.index + 1) * n],
                                   ax)
    want = torch.logsumexp(x, dim=-1)
    return float(((got - want).abs() / want.abs()).max())


def _rank(world, params, batches):
    import torch.distributed as tdist
    rank = tdist.get_rank()
    out = {"cases": {}, "one": {}}
    for shape in MESHES[world]:
        for arch, sp in CASES:
            out["cases"][(arch, sp, shape)] = _case(
                arch, sp, shape, params[arch], batches[arch], rank)
    if rank == 0:
        for arch in ARCHS:
            out["one"][arch] = _one_rank(arch, params[arch], batches[arch])
    if world == 2:
        out["flops"] = _flops(params["yi_6b"], batches["yi_6b"], (1, 2))
        if rank == 0:
            out["flops_one"] = _flops(params["yi_6b"], batches["yi_6b"],
                                      None)
        out["lse"] = _lse()
    else:
        out["tp_sum"] = _tp_sum()
    return out


# ------------------------------------------------------- the references
def _jit(f, *args):
    import jax
    return jax.jit(f).lower(*args).compile(compiler_options=FAST_COMPILE)


def _jax_init(arch):
    import jax
    from repro.models import api as japi
    jcfg = _jcfg(arch)
    key = jax.random.PRNGKey(0)
    return jax.tree.map(np.asarray, _jit(
        lambda k: japi.init_params(jcfg, k), key)(key))


def _reference_first_fit(arch, shape):
    """The spec the reference's own attention (``repro/models/
    transformer.py``: its KV-head repeat, then its first fit) picks on a
    (data, model) mesh of ``shape``, with the reference's rule lookups
    answered by a stand-in of that mesh and the fit recorded (this
    process has one device)."""
    import jax
    import jax.numpy as jnp
    from repro import sharding as SH
    from repro.models import transformer as JT
    jcfg = _jcfg(arch)
    kind = next(k for k in jcfg.pattern if k.startswith("attn"))

    class Mesh:
        axis_names = ("data", "model")

    class Rules:
        mesh = Mesh()
    Mesh.shape = dict(zip(Mesh.axis_names, shape))
    seen = []

    def fit(x, specs):
        seen.append(next((tuple(s) for s in specs
                          if SH._spec_fits(Rules.mesh, s, x.shape)), None))
        return x
    saved = (SH.current_rules, SH.current_dp, SH.constrain_first_fit)
    SH.current_rules, SH.current_dp = (lambda: Rules), (lambda: ("data",))
    SH.constrain_first_fit = fit
    try:
        p = JT.attn_params(jcfg, jax.random.PRNGKey(0), kind)
        x = jnp.zeros(BATCH + (jcfg.d_model,), jnp.float32)
        JT.attention(jcfg, p, x, kind=kind,
                     positions=jnp.arange(BATCH[1], dtype=jnp.int32))
    finally:
        SH.current_rules, SH.current_dp, SH.constrain_first_fit = saved
    spec = seen[-1]
    return None if spec is None else sharding.P(*spec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    params = {a: _jax_init(a) for a in ARCHS}
    batches = {a: _batches(a) for a in ARCHS}
    dirs = {w: tmp_path_factory.mktemp(f"tp{w}") for w in MESHES}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {w: pool.submit(
            run_ranks, _rank, w, backend="gloo", device="cpu",
            store_dir=dirs[w] / "store", timeout=300,
            args=(w, params, batches)) for w in MESHES}
        ref = {a: _jax_steps(a, params[a], batches[a], jcfg=_jcfg(a))
               for a in ARCHS}
        fits = {(a, s): _reference_first_fit(a, s) for a in ARCHS
                if any(k.startswith("attn") for k in _cfg(a).pattern)
                for w in MESHES for s in MESHES[w]}
        ranks = {w: f.result() for w, f in futs.items()}
    return dict(ranks=ranks, ref=ref, fits=fits)


ALL = [(a, sp, s) for w in MESHES for s in MESHES[w] for a, sp in CASES]


def _get(runs, arch, sp, shape):
    ranks = runs["ranks"][shape[0] * shape[1]]
    return ranks, ranks[0]["cases"][(arch, sp, shape)]


@pytest.mark.parametrize("arch,sp,shape", ALL)
def test_tp_step_matches_reference(runs, arch, sp, shape):
    """Loss, grad norm and parameters within the bounds of the JAX
    package's unsharded step; every rank reports the same metrics; the
    step moved bytes over the model axis."""
    ranks, case = _get(runs, arch, sp, shape)
    metrics, want, grads = runs["ref"][arch]
    _metrics_close(case["metrics"], metrics, (arch, sp, shape))
    err = _param_err(_cfg(arch), case["params"], want, grads)
    assert err <= PARAM_TOL, (arch, sp, shape, err)
    assert all(r["cases"][(arch, sp, shape)]["metrics"] == case["metrics"]
               for r in ranks)
    assert case["tp"] > 0


@pytest.mark.parametrize("arch,sp,shape", ALL)
def test_tp_step_matches_one_rank(runs, arch, sp, shape):
    ranks, case = _get(runs, arch, sp, shape)
    one = ranks[0]["one"][arch]
    _metrics_close(case["metrics"], one["metrics"], (arch, sp, shape))
    _params_close(case["params"], one["params"], (arch, sp, shape),
                  one["grads"])


@pytest.mark.parametrize("arch,sp,shape", ALL)
def test_tp_grads_match_reference(runs, arch, sp, shape):
    """Every step's gradients, before the optimizer, within ``GRAD_RTOL``
    of the JAX package's: the split products' backward (column inputs'
    sums, sliced parameters' gathers, the repeat's and the query split's
    summed weight gradients) leaf by leaf."""
    _, case = _get(runs, arch, sp, shape)
    _grads_close(case["grads"], runs["ref"][arch][2], (arch, sp, shape),
                 _cfg(arch))


@pytest.mark.parametrize("arch,sp,shape", ALL)
def test_tp_grads_match_one_rank(runs, arch, sp, shape):
    ranks, case = _get(runs, arch, sp, shape)
    _grads_close(case["grads"], ranks[0]["one"][arch]["grads"],
                 (arch, sp, shape))


@pytest.mark.parametrize("arch,sp,shape", ALL)
def test_tp_prefill_and_decode_match_one_rank(runs, arch, sp, shape):
    ranks, _ = _get(runs, arch, sp, shape)
    for r in ranks:
        case = r["cases"][(arch, sp, shape)]
        assert case["prefill"] <= ATOL, case["prefill"]
        assert case["decode"] <= ATOL, case["decode"]


def test_decode_runs_both_cache_splits(runs):
    """The decode cases cover a KV-head split cache (dim 3 of the stacked
    leaf) and a sequence-split one (dim 2)."""
    got = {(a, s): runs["ranks"][s[0] * s[1]][0]["cases"][(a, False, s)]
           ["cache_split"] for a in ("yi_6b", "granite_34b",
                                     "recurrentgemma_2b")
           for w in MESHES for s in MESHES[w]}
    assert got[("yi_6b", (1, 2))] == 3
    assert got[("yi_6b", (1, 4))] == 2
    assert got[("granite_34b", (1, 2))] == 2
    assert got[("recurrentgemma_2b", (1, 4))] == 2


@pytest.mark.parametrize("arch,shape", sorted(
    {(a, s) for a in ARCHS if a != "rwkv6_1b6"
     for w in MESHES for s in MESHES[w]}))
def test_first_fit_is_the_references(runs, arch, shape):
    """The port's recorded first fit equals the reference's own choice
    after its repeat: heads for yi_6b, granite_34b and olmoe_1b_7b
    everywhere, the query time for recurrentgemma_2b's 2 heads on 4."""
    _, case = _get(runs, arch, False, shape)
    assert case["first_fit"] == runs["fits"][(arch, shape)], \
        (case["first_fit"], runs["fits"][(arch, shape)])
    if arch == "recurrentgemma_2b" and shape == (1, 4):
        assert case["first_fit"] == ("data", "model", None, None, None)


def test_split_blocks_named(runs):
    """What each rank computes on as its model block: the head split's
    ``wq`` / ``wo`` (``wk`` / ``wv`` too where the KV heads divide the
    axis), the MLP's width, the vocabulary; the query-time split keeps the
    attention whole."""
    split = {k: v["split"] for k, v in
             runs["ranks"][4][0]["cases"].items()}
    yi2 = split[("yi_6b", False, (2, 2))]
    assert "layers.0.mixer.wk.weight" in yi2
    assert {"embed.weight", "head.weight", "layers.0.mixer.wq.weight",
            "layers.0.ffn.w_in.weight"} <= set(yi2)
    yi4 = split[("yi_6b", False, (1, 4))]
    assert "layers.0.mixer.wq.weight" in yi4
    assert "layers.0.mixer.wk.weight" not in yi4
    rg4 = split[("recurrentgemma_2b", False, (1, 4))]
    assert not any(n.startswith("layers.2.mixer.") for n in rg4)
    assert "layers.0.mixer.w_x.weight" in rg4


def test_tp_sum_is_the_ordered_sum(runs):
    """On a model axis of 4 the split compute's sum (a sum-scatter, then a
    gather) gives the bits of the ordered sum of the whole parts and
    receives 2 (n - 1) / n of a part where the whole parts' gather
    receives n - 1."""
    for r in runs["ranks"][4]:
        same, tp, whole, part = r["tp_sum"]
        assert same
        assert tp == 2 * 3 / 4 * part, (tp, part)
        assert whole == 3 * part, (whole, part)


def test_split_logsumexp(runs):
    for r in runs["ranks"][2]:
        assert r["lse"] <= LSE_RTOL, r["lse"]


def test_each_rank_does_its_share(runs):
    """yi_6b (dense) on (1, 2): a rank's FLOPs at most FLOPS_SHARE of one
    rank's, on both ranks."""
    ranks = runs["ranks"][2]
    one = ranks[0]["flops_one"]
    for r in ranks:
        assert r["flops"] <= FLOPS_SHARE * one, (r["flops"], one)


# ------------------------------------------------------------- the card
def _card_rank(params, batches):
    cfg = _cfg("yi_6b")
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"), backend="gloo",
                     device="cuda")
    sm = sharding.ShardedModel(convert.from_reference(
        cfg, params, device="cuda"), sharding.Rules(mesh, fsdp=True))
    opt = Recording(**OPT)
    state = opt.init(sm)
    step = make_train_step(cfg, opt, remat=True)
    with sm.rules.activate():
        metrics = [{k: float(v) for k, v in step(sm, state, {
            k: torch.from_numpy(v).cuda() for k, v in b.items()}).items()}
            for b in batches]
    return dict(metrics=metrics, params={
        n: sm.shardings[n].gather(t).cpu() for n, t in sm.params.items()},
        grads=[{n: sm.shardings[n].gather(g).cpu() for n, g in s.items()}
               for s in opt.seen])


@pytest.mark.cuda
def test_tp_step_on_the_card(tmp_path):
    """Two gloo ranks sharing the card on (1, 2), reduced yi_6b (float32,
    the initial weights drawn on the CPU): heads, MLP width and vocabulary
    split, within the bounds of one rank on the card (gradients, and
    parameters by the eps rule)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = _cfg("yi_6b")
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = convert.to_reference(cfg, dict(model.named_parameters()),
                                  convert.reference_shapes(cfg))
    batches = _batches("yi_6b")
    out = run_ranks(_card_rank, 2, backend="gloo", device="cuda",
                    store_dir=tmp_path / "store", args=(params, batches))
    one = convert.from_reference(cfg, params, device="cuda")
    opt = Recording(**OPT)
    state = opt.init(one)
    step = make_train_step(cfg, opt, remat=True)
    want = [{k: float(v) for k, v in step(one, state, {
        k: torch.from_numpy(v).cuda() for k, v in b.items()}).items()}
        for b in batches]
    ones = {k: v.detach().cpu() for k, v in one.named_parameters()}
    grads = [{k: g.cpu() for k, g in s.items()} for s in opt.seen]
    for r in out:
        _metrics_close(r["metrics"], want, "card")
        _grads_close(r["grads"], grads, "card")
        _params_close(r["params"], ones, "card", grads)
