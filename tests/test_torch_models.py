"""The port's language-model stack (``repro_torch.configs``,
``repro_torch.models``, ``launch/serve.py``'s ``generate``) against the
JAX package, in float32 on the CPU.

The JAX side runs under ``jax.jit``; its parameter tree goes to the port
through ``convert.from_reference`` (or ``convert.carry`` for one module),
and both packages get the same numpy inputs.  Each arch's reference
(forward logits, loss, 20 decode steps, ``generate``'s tokens) is
computed once, in a module-scoped fixture.

Tolerances, float32: logits and module outputs within ``ATOL`` = 5e-5
absolute (the JAX package's own bound for decode against forward,
tests/test_models.py), the loss within 1e-5 relative; greedy tokens and
integer shapes equal.
"""
import dataclasses
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.configs import input_specs as jax_input_specs
from repro.configs import runnable_cells as jax_cells
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import mlp as JMLP
from repro.models import moe as JMOE
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.launch import serve
from repro_torch.models import api, convert, frontends
from repro_torch.models import layers as L
from repro_torch.models import mlp as MLP
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models import transformer as T

ATOL = 5e-5
LOSS_RTOL = 1e-5
B, S = 2, 20                    # forward / decode batch and length
PROMPT, GEN = 4, 4              # generate
CAUSAL = [a for a in C.ARCH_IDS if C.get_reduced(a).causal]
TOKEN_IN = [a for a in CAUSAL if not C.get_reduced(a).embedding_inputs]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _inputs(cfg, rng, b, s):
    if cfg.embedding_inputs:
        return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _pair(name, **changes):
    """(JAX config, port config): a reduced config, changed alike."""
    return (dataclasses.replace(jax_reduced(name), **changes),
            dataclasses.replace(C.get_reduced(name), **changes))


#: XLA CPU options of the reference's compiles: without LLVM's costly
#: passes (about a third of the compile time).  XLA's own graph passes
#: still run, and LLVM without fast-math keeps IEEE results.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(f, *args):
    """``f`` under ``jax.jit``, compiled for ``args``' shapes."""
    return jax.jit(f).lower(*args).compile(compiler_options=FAST_COMPILE)


def _call(f, *args):
    return _jit(f, *args)(*args)


def _init_params(jcfg, seed):
    return _call(lambda k: japi.init_params(jcfg, k),
                 jax.random.PRNGKey(seed))


def _reference(jcfg, cfg, seed=0):
    """The JAX package's outputs for one config, and the port's model
    holding the same weights."""
    rng = np.random.default_rng(seed)
    x = _inputs(jcfg, rng, B, S)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)

    params = _init_params(jcfg, seed)
    logits, loss = _call(lambda p, x, y: (
        japi.forward(jcfg, p, x)[0], japi.loss_fn(jcfg, p, x, y)[0]),
        params, x, labels)
    out = dict(params=_np_tree(params), x=x, labels=labels,
               logits=np.asarray(logits), loss=float(loss),
               model=convert.from_reference(cfg, _np_tree(params),
                                            device="cpu"))
    if jcfg.causal:
        cache = japi.init_cache(jcfg, B, S, dtype=jnp.float32)
        cl = jnp.zeros((), jnp.int32)
        step = _jit(lambda p, t, c, l: japi.decode_step(jcfg, p, t, c, l),
                    params, x[:, :1], cache, cl)
        steps = []
        for i in range(S):
            lg, cache, cl = step(params, x[:, i:i + 1], cache, cl)
            steps.append(np.asarray(lg[:, 0]))
        out["decode"] = np.stack(steps, axis=1)
    if jcfg.causal and not jcfg.embedding_inputs:
        out["prompt"] = x[:, :PROMPT]
        out["generated"] = np.asarray(jserve.generate(
            jcfg, params, jnp.asarray(out["prompt"]), PROMPT + GEN + 1, GEN))
    return out


@pytest.fixture(scope="module")
def ref():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = _reference(jax_reduced(arch), C.get_reduced(arch))
        return memo[arch]
    return get


def _port_decode(cfg, model, x, steps):
    cache = api.init_cache(cfg, x.shape[0], steps, dtype=torch.float32,
                           device="cpu")
    cl, out = 0, []
    for i in range(steps):
        lg, cache, cl = api.decode_step(cfg, model, _t(x[:, i:i + 1]),
                                        cache, cl)
        out.append(lg[:, 0])
    assert cl == steps
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------- configs
def test_the_same_architectures():
    assert C.ARCH_IDS == JAX_ARCH_IDS
    for arch in C.ARCH_IDS + ["pgf_tpch"]:
        jmod = import_module(f"repro.configs.{arch}")
        tmod = import_module(f"repro_torch.configs.{arch}")
        assert dataclasses.asdict(tmod.CONFIG) \
            == dataclasses.asdict(jmod.CONFIG), arch
        assert dataclasses.asdict(tmod.reduced()) \
            == dataclasses.asdict(jmod.reduced()), arch


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_counts_and_cells(arch):
    cfg, jcfg = C.get_config(arch), jax_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.n_periods == jcfg.n_periods
    assert C.runnable_cells(cfg) == jax_cells(jcfg)
    # the formula against the port's own full-width model (on ``meta``)
    numel = sum(p.numel() for p in api.Model(cfg, device="meta")
                .parameters())
    assert abs(numel - cfg.param_count()) / numel < 0.30, \
        (numel, cfg.param_count())


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_numel_equals_the_reference_tree(ref, arch):
    tree = ref(arch)["params"]
    assert sum(p.numel() for p in ref(arch)["model"].parameters()) \
        == sum(a.size for a in jax.tree.leaves(tree))


def _spec_tree(x):
    if isinstance(x, dict):
        return {k: _spec_tree(v) for k, v in x.items()}
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch,cell", [
    (a, c) for a in C.ARCH_IDS for c in C.runnable_cells(C.get_config(a))])
def test_input_specs(arch, cell):
    got = C.input_specs(C.get_config(arch), cell, batch_override=2)
    want = jax_input_specs(jax_config(arch), cell, batch_override=2)
    assert all(v.device.type == "meta"
               for v in jax.tree.leaves(got, is_leaf=torch.is_tensor))
    assert _spec_tree(got) == _spec_tree(want)


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_norms(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(dtype)
    g, b = rng.normal(size=48).astype(np.float32), \
        rng.normal(size=48).astype(np.float32)
    tx = convert._tensor(x)
    got = L.rms_norm(tx, _t(g))
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(g))
    assert got.dtype == tx.dtype
    atol = ATOL if dtype is np.float32 else 0.05
    _close(got.float(), np.asarray(want, np.float32), atol)
    _close(L.layer_norm(tx, _t(g), _t(b)).float(),
           np.asarray(JL.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b)), np.float32), atol)


@pytest.mark.parametrize("pct", [1.0, 0.5, 0.0])
def test_rope(pct):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = np.arange(5, 17, dtype=np.int32)
    want = JL.apply_rope(jnp.asarray(x), JL.rope_tables(
        jnp.asarray(pos), 16, pct, 10000.0))
    tables = L.rope_tables(_t(pos), 16, pct, 10000.0)
    assert (tables is None) == (pct == 0.0)
    _close(L.apply_rope(_t(x), tables), want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "relu2",
                                  "rwkv_channel"])
def test_mlp(kind):
    jcfg, cfg = _pair("yi_6b", mlp=kind)
    p = _np_tree(JMLP.mlp_params(jcfg, jax.random.PRNGKey(2)))
    m = convert.carry(MLP.MLP(cfg, device="meta"), p)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    sh = rng.normal(size=x.shape).astype(np.float32) \
        if kind == "rwkv_channel" else None
    want = JMLP.mlp(jcfg, p, jnp.asarray(x),
                    shifted=None if sh is None else jnp.asarray(sh))
    _close(m(_t(x), None if sh is None else _t(sh)), want)


@pytest.mark.parametrize("case", ["causal", "bidirectional", "local",
                                  "two_chunks"])
def test_attention(case):
    """The cache-less path: masks, GQA pairing, and (two_chunks) the
    online softmax over two 550-key chunks."""
    name = "hubert_xlarge" if case == "bidirectional" else "yi_6b"
    kind = "attn_local" if case == "local" else "attn"
    jcfg, cfg = _pair(name, window=8 if case == "local" else 0)
    p = _np_tree(JT.attn_params(jcfg, jax.random.PRNGKey(3), kind))
    if jcfg.attn_bias:          # zero at init: make the carry visible
        rng = np.random.default_rng(4)
        p.update({k: rng.normal(size=p[k].shape).astype(np.float32)
                  for k in ("bq", "bk", "bv")})
    m = convert.carry(T.Attention(cfg, kind, device="meta"), p)
    t = 1100 if case == "two_chunks" else 24
    x = np.random.default_rng(3).normal(size=(2, t, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(t, dtype=np.int32)
    want, _ = _call(lambda p, x: JT.attention(
        jcfg, p, x, kind=kind, positions=jnp.asarray(pos)), p, x)
    _close(m(_t(x), _t(pos)), want)


def test_moe_drops_the_same_tokens():
    """Published capacity factor 1.25 on the reduced width: the same
    tokens overflow in both packages, and the aux loss agrees."""
    jcfg, cfg = _pair("olmoe_1b_7b", capacity_factor=1.25)
    p = _np_tree(JMOE.moe_params(jcfg, jax.random.PRNGKey(5)))
    m = convert.carry(MOE.MoE(cfg, device="meta"), p)
    # tokens leaning towards expert 0, so that it overflows
    r0 = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    x = (np.random.default_rng(5).normal(size=(2, 64, cfg.d_model))
         + 4.0 * r0).astype(np.float32)
    top = np.argsort(-(x.reshape(-1, cfg.d_model) @ p["router"]),
                     axis=-1)[:, :cfg.top_k]
    assert np.bincount(top.ravel(), minlength=cfg.n_experts).max() \
        > MOE.capacity(cfg, 128), "nothing overflows: the case tests nothing"
    want, waux = _call(lambda p, x: JMOE.moe(jcfg, p, x), p, x)
    got, aux = m(_t(x))
    _close(got, want)
    assert float(aux.detach()) == pytest.approx(float(waux), rel=LOSS_RTOL)


@pytest.mark.parametrize("t", [512, 37])
def test_rglru(t):
    """Two 256-step chunks, and an odd length (one chunk)."""
    jcfg, cfg = _pair("recurrentgemma_2b")
    p = _np_tree(JRG.rglru_params(jcfg, jax.random.PRNGKey(6)))
    m = convert.carry(RG.RGLRU(cfg, device="meta"), p)
    x = np.random.default_rng(6).normal(size=(2, t, cfg.d_model)) \
        .astype(np.float32)
    want, _ = _call(lambda p, x: JRG.rglru(jcfg, p, x), p, x)
    _close(m(_t(x)), want)


def test_rwkv6_timemix():
    """T = 70: padded to two 64-step chunks; a nonzero bonus ``u``."""
    jcfg, cfg = _pair("rwkv6_1b6")
    p = _np_tree(JRW.rwkv6_params(jcfg, jax.random.PRNGKey(7)))
    p["u"] = np.random.default_rng(7).normal(size=p["u"].shape) \
        .astype(np.float32)
    m = convert.carry(RW.RWKV6TimeMix(cfg, device="meta"), p)
    x = np.random.default_rng(8).normal(size=(2, 70, cfg.d_model)) \
        .astype(np.float32)
    want, _ = _call(lambda p, x: JRW.rwkv6_timemix(jcfg, p, x), p, x)
    _close(m(_t(x)), want)


# ------------------------------------------------------------ whole archs
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_forward(ref, arch):
    r = ref(arch)
    cfg = C.get_reduced(arch)
    logits, cache, aux = api.forward(cfg, r["model"], _t(r["x"]))
    assert cache is None and logits.shape == (B, S, cfg.vocab_size)
    _close(logits, r["logits"])
    _close(api.prefill(cfg, r["model"], _t(r["x"])), r["logits"])


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_loss(ref, arch):
    r = ref(arch)
    loss, parts = api.loss_fn(C.get_reduced(arch), r["model"], _t(r["x"]),
                              _t(r["labels"]))
    assert float(loss) == pytest.approx(r["loss"], rel=LOSS_RTOL)
    assert float(parts["ce"]) == pytest.approx(np.log(C.get_reduced(arch)
                                               .vocab_size), rel=0.25)


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode(ref, arch):
    """20 single-token steps against JAX's decode logits (recurrentgemma's
    16-slot ring wraps) and against the port's own forward."""
    r = ref(arch)
    cfg = C.get_reduced(arch)
    got = _port_decode(cfg, r["model"], r["x"], S)
    _close(got, r["decode"])
    _close(got, r["logits"])


@pytest.mark.parametrize("arch", TOKEN_IN)
def test_generate(ref, arch):
    r = ref(arch)
    got = serve.generate(C.get_reduced(arch), r["model"], _t(r["prompt"]),
                         PROMPT + GEN + 1, GEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), r["generated"])


def test_generate_refuses_embedding_inputs(ref):
    """Generated ids cannot feed an embedding-input model: the reference
    fails inside its first decode step, the port before it."""
    r = ref("internvl2_26b")
    jcfg, cfg = jax_reduced("internvl2_26b"), C.get_reduced("internvl2_26b")
    x = r["x"][:, :PROMPT]
    with pytest.raises(ValueError, match="embedding"):
        serve.generate(cfg, r["model"], _t(x), PROMPT + GEN + 1, GEN)
    with pytest.raises((TypeError, ValueError)):
        jserve.generate(jcfg, jax.tree.map(jnp.asarray, r["params"]),
                        jnp.asarray(x), PROMPT + GEN + 1, GEN)


def test_tail_layers():
    """recurrentgemma with one period and its 2-layer tail (5 layers), a
    shape no reduced config has: forward and 20 decode steps."""
    jcfg, cfg = _pair("recurrentgemma_2b", n_layers=5,
                      tail_pattern=("rglru", "rglru"))
    r = _reference(jcfg, cfg, seed=3)
    assert len(r["model"].layers) == 5 and "tail" in r["params"]
    _close(api.forward(cfg, r["model"], _t(r["x"]))[0], r["logits"])
    _close(_port_decode(cfg, r["model"], r["x"], S), r["decode"])
    np.testing.assert_array_equal(
        serve.generate(cfg, r["model"], _t(r["prompt"]), PROMPT + GEN + 1,
                       GEN).numpy(), r["generated"])


def test_bfloat16_forward():
    """The reference's dtype at full width, on a reduced width: logits
    within bfloat16 rounding (0.05 absolute on unit-scale logits)."""
    jcfg, cfg = _pair("yi_6b", dtype="bfloat16")
    x = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S))

    params = _init_params(jcfg, 9)
    want = _call(lambda p, x: japi.forward(jcfg, p, x)[0], params, x)
    model = convert.from_reference(cfg, _np_tree(params), device="cpu")
    assert model.layers[0].mixer.wq.weight.dtype == torch.bfloat16
    got = api.forward(cfg, model, _t(x))[0]
    _close(got.float(), np.asarray(want, np.float32), 0.05)


# ---------------------------------------------------------- entry points
def test_serve_main(capsys):
    assert serve.main(["--arch", "rwkv6_1b6", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "3",
                       "--gen", "2"]) == 0
    assert "arch=rwkv6_smoke generated (2, 2)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "internvl2_26b", "--device", "cpu"])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = C.get_reduced("yi_6b")
    for call in (lambda: api.init_params(cfg, torch.Generator()),
                 lambda: api.init_cache(cfg, 1, 4),
                 lambda: convert.from_reference(cfg, {}),
                 lambda: frontends.fake_embeddings(torch.Generator(), 1, 2,
                                                   8),
                 lambda: serve.main(["--arch", "yi_6b"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_init_params_is_seeded():
    cfg = C.get_reduced("olmoe_1b_7b")
    a, b = (api.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu") for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert float(a.layers[0].ffn.experts_in.std()) == pytest.approx(
        cfg.d_model ** -0.5 * 0.88, rel=0.1)     # truncated at 2 sigma
