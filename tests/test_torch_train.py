"""The port's training substrate (``repro_torch.train``,
``launch/train.py``) on the CPU: the reference's tests/test_train.py cases
ported, and parity with the JAX package on the same numpy inputs.

Parity bounds, float32: one AdamW update of each package from the same
params, gradients and state (reduced yi_6b, step 5 -> 6), in units in
the last place of the update's larger operand max(|p|, lr): the port
within ``IEEE_ULPS`` = 2 of the reference's formula evaluated in numpy
float32 (correctly rounded division and square root; PyTorch's CPU sqrt
is Sleef's, within 0.5001 ulp), and within ``ULPS`` = 32 of the JAX
package, whose XLA CPU float32 division and square root are not
correctly rounded (the reference itself lands 8-9 ulps from numpy on a
plain 64 x 512 update).  Measured: port vs numpy 1 ulp, port vs JAX 16
(the head); the moments equal bit for bit (bf16 moments too).  The whole train step
(reduced yi_6b) against the reference's ``make_train_step`` on the loss
and the global gradient norm within ``STEP_RTOL`` = 1e-5 relative (the
parameters are held through the gradient and update parities instead:
AdamW's first step is about lr * sign(g), so an element whose gradient is
at noise level can flip by 2 lr).  The batch-size PGF of the sampler
(float32, the plain logcf on the CPU) within ``PGF_ATOL`` = 1e-6 of the
reference's float64 PGF, and in float64 its capacities equal.  ``compressed_psum``
over 4 gloo ranks equals the reference's under ``jax.vmap`` (the integer
sums are exact and the scale a maximum) within ``PSUM_ULPS`` = 2, its
residual within 2 ulps of g + err (it cancels).

The JAX package is imported inside the tests only: the ranks of the
``compressed_psum`` test import this module.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.launch import train as launch_train
from repro_torch.models import api, convert
from repro_torch.testing.ranks import run_ranks
from repro_torch.train import checkpoint as ck
from repro_torch.train.data import ProbabilisticSampler, TokenStream
from repro_torch.train.optimizer import (AdamW, clip_by_global_norm,
                                         compress_int8, compressed_psum,
                                         decompress_int8, global_norm)
from repro_torch.train.trainer import (Trainer, make_train_step,
                                       run_with_failures)

ULPS = 32
IEEE_ULPS = 2
PSUM_ULPS = 2
LR = np.float32(1e-2)
STEP_RTOL = 1e-5
PGF_ATOL = 1e-6

#: XLA CPU options of the reference's compiles (tests/test_torch_models.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(f, *args):
    import jax
    return jax.jit(f).lower(*args).compile(compiler_options=FAST_COMPILE)


def _cpu_stream(cfg, **kw):
    return TokenStream(cfg.vocab_size, device="cpu", **kw)


# ------------------------------------------ the reference's cases, ported
def test_adamw_decreases_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup=1)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 0.05
    assert int(state.step) == 200


def test_adamw_bf16_moments_roundtrip():
    opt = AdamW(lr=1e-2, moment_dtype="bfloat16", warmup=1)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.mu["w"].dtype == torch.bfloat16
    opt.update({"w": torch.ones((4,), dtype=torch.bfloat16)}, state, params)
    assert params["w"].dtype == torch.bfloat16
    assert float(params["w"][0]) < 1.0


def test_clip_by_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, n = clip_by_global_norm(tree, 1.0)
    assert clipped is tree                       # scaled in place
    assert float(n) == pytest.approx(5.0)
    assert float(global_norm(tree)) == pytest.approx(1.0, rel=1e-6)


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 1, 1000).astype(np.float32))
    err = torch.zeros_like(g)
    total_sent = torch.zeros_like(g)
    total_true = torch.zeros_like(g)
    for _ in range(20):
        q, scale, err = compress_int8(g, err)
        total_sent = total_sent + decompress_int8(q, scale)
        total_true = total_true + g
    rel = float((total_sent - total_true).abs().max()
                / total_true.abs().max())
    assert rel < 1e-2


def test_checkpoint_atomic_and_verified(tmp_path):
    tree = {"w": torch.arange(10.0), "b": {"x": torch.ones((3,))}}
    d = str(tmp_path / "ck")
    ck.save(d, 7, tree)
    os.makedirs(os.path.join(d, "step_00000009.tmp-dead"))  # a torn save
    assert ck.latest_step(d) == 7
    like = {"w": torch.empty(10), "b": {"x": torch.empty(3)}}
    restored, manifest = ck.restore(d, 7, like)
    assert torch.equal(restored["w"], tree["w"])
    assert manifest["keys"] == ["b/x", "w"]
    # shardings that name no leaf place nothing (placement on a mesh:
    # tests/test_torch_mesh_train.py)
    unplaced, _ = ck.restore(d, 7, like, shardings={})
    assert torch.equal(unplaced["b"]["x"], tree["b"]["x"])
    # corruption detection
    shard = os.path.join(d, "step_00000007", "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(50)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError, match="corruption"):
        ck.restore(d, 7, like)


def test_checkpoint_restart_bit_identical(tmp_path):
    cfg = C.get_reduced("yi_6b")
    stream = _cpu_stream(cfg, seq_len=16, global_batch=4)
    opt = AdamW(lr=1e-3, warmup=5)
    t1 = Trainer(cfg, opt, stream, str(tmp_path / "a"), ckpt_every=3,
                 device="cpu")
    m1, s1, h1 = t1.run(8)
    t2 = Trainer(cfg, opt, stream, str(tmp_path / "b"), ckpt_every=3,
                 device="cpu")
    m2, s2, h2, attempts = run_with_failures(t2, 8, {4})
    assert attempts == 2
    assert int(s1.step) == int(s2.step) == 8
    assert h2 == h1[3:]          # the second attempt resumed at step 3
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    for n in s1.mu:
        assert torch.equal(s1.mu[n], s2.mu[n]) \
            and torch.equal(s1.nu[n], s2.nu[n]), n


def test_grad_accumulation_equivalence():
    """accum=2 == accum=1 on the same global batch (linearity of grads)."""
    cfg = C.get_reduced("yi_6b")
    opt = AdamW(lr=1e-2, weight_decay=0.0, warmup=1)
    batch = _cpu_stream(cfg, seq_len=16, global_batch=4, seed=1).batch(0)
    out = []
    for accum in (1, 2):
        model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        state = opt.init(model)
        m = make_train_step(cfg, opt, accum=accum)(model, state, batch)
        out.append((model, m))
    (p1, m1), (p2, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    d = max(float((a - b).detach().abs().max()) for a, b in
            zip(p1.parameters(), p2.parameters()))
    assert d < 1e-4, d    # f32 association-order noise through AdamW


def test_token_stream_deterministic_and_shardable():
    s = TokenStream(1000, seq_len=8, global_batch=8, seed=3, device="cpu")
    b1, b2 = s.batch(5), s.batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["tokens"], s.batch(6)["tokens"])
    sh0 = s.batch(5, shard=0, num_shards=2)
    assert sh0["tokens"].shape == (4, 8)
    assert not torch.equal(sh0["tokens"],
                           s.batch(5, shard=1, num_shards=2)["tokens"])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 1000
    e = TokenStream(1000, seq_len=8, global_batch=2, seed=3,
                    embedding_dim=16, device="cpu")
    eb = e.batch(0)
    assert eb["tokens"].shape == (2, 8, 16)
    assert eb["tokens"].dtype == torch.float32
    assert torch.equal(eb["tokens"], e.batch(0)["tokens"])
    with pytest.raises(ValueError):
        s.batch(0, num_shards=3)


def test_probabilistic_sampler_capacity():
    """The PGF-backed capacity bound is sound: simulate inclusion draws."""
    rng = np.random.default_rng(0)
    probs = rng.uniform(0.2, 0.9, 128)
    s = ProbabilisticSampler(probs, seed=1, device="cpu")
    cap = s.capacity_for(1e-4)
    draws = np.array([s.draw(i).sum() for i in range(500)])
    assert (draws > cap).mean() < 0.01
    assert np.array_equal(s.draw(3), s.draw(3))
    mean = float(s.batch_size_pgf().mean())
    assert mean == pytest.approx(probs.sum(), rel=1e-5)   # float32 PGF


def test_sampler_reaches_the_logcf_wrapper_once(monkeypatch):
    """A pool of 256 to 8,191 float32 probabilities takes the logcf
    kernel's wrapper once (on the CPU it computes the plain version)."""
    from repro_torch.kernels import pb_cf
    calls = []
    real = pb_cf.logcf

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(pb_cf, "logcf", counted)
    s = ProbabilisticSampler(np.full(4096, 0.5), device="cpu")
    s.batch_size_pgf()
    assert calls == [(4096,)]


# -------------------------------------------------- JAX parity: optimizer
def _adamw_numpy(kw, step, p, g, m, v):
    """The reference's update formula in numpy float32 (IEEE division and
    square root), one leaf: (new p, new m, new v)."""
    f = np.float32
    lr = f(kw["lr"]) * min(f(1.0), (f(step) + f(1)) / f(kw["warmup"]))
    t = f(step + 1)
    c1, c2 = f(1) - f(0.9) ** t, f(1) - f(0.95) ** t
    g32 = g.astype(f)
    m32 = 0.9 * m.astype(f) + (1 - 0.9) * g32
    v32 = 0.95 * v.astype(f) + (1 - 0.95) * g32 * g32
    upd = (m32 / c1) / (np.sqrt(v32 / c2) + 1e-8)
    upd = upd + 0.1 * p.astype(f)
    return ((p.astype(f) - lr * upd).astype(p.dtype), m32.astype(m.dtype),
            v32.astype(v.dtype))


def _opt_parity(moment_dtype):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as jax_reduced
    from repro.models import api as japi
    from repro.train import optimizer as jopt
    jcfg, cfg = jax_reduced("yi_6b"), C.get_reduced("yi_6b")
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, _jit(
        lambda k: japi.init_params(jcfg, k), key)(key))
    rng = np.random.default_rng(1)
    like = lambda p: rng.normal(0, 1e-2, np.shape(p)).astype(np.float32)
    grads = jax.tree.map(like, params)
    kw = dict(lr=LR, warmup=7, moment_dtype=moment_dtype)
    jo, po = jopt.AdamW(**kw), AdamW(**kw)
    mdt = jnp.bfloat16 if moment_dtype else jnp.float32
    state = jopt.AdamWState(
        jnp.asarray(5, jnp.int32),
        jax.tree.map(lambda p: jnp.asarray(like(p), mdt), params),
        jax.tree.map(lambda p: jnp.asarray(np.abs(like(p)), mdt), params))
    state = jax.tree.map(np.asarray, state)
    new_p, new_s = _jit(lambda p, g, s: jo.update(g, s, p),
                        params, grads, state)(params, grads, state)
    ieee = jax.tree.map(lambda *a: _adamw_numpy(kw, 5, *a), params, grads,
                        state.mu, state.nu)
    ieee = tuple(jax.tree.map(lambda o: o[i], ieee,
                              is_leaf=lambda x: isinstance(x, tuple))
                 for i in range(3))

    model = convert.from_reference(cfg, params, device="cpu")
    pstate = convert.opt_state_from_reference(cfg, state, model)
    pgrads = convert.state_from_reference(cfg, grads)
    po.update(pgrads, pstate, model)
    got_p = convert.to_reference(cfg, dict(model.named_parameters()), params)
    return dict(
        jax=jax.tree.map(np.asarray, (new_p, new_s.mu, new_s.nu)),
        ieee=ieee,
        port=(got_p, convert.to_reference(cfg, pstate.mu, params),
              convert.to_reference(cfg, pstate.nu, params)),
        steps=(int(np.asarray(new_s.step)), int(pstate.step)))


def _ulps_apart(got, want, what):
    """Max distance of the port's tree from ``want`` leaf by leaf: in ulps
    of the update's larger operand max(|p|, lr) for the parameters (a
    parameter near 0 still moves by about lr), in ulps of the value for
    the moments (one bf16 ulp is 2^-7 of the magnitude's power of two)."""
    import jax
    worst = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w)
        bf16 = w.dtype.name == "bfloat16"
        w = w.astype(np.float32)
        if bf16:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(w) + 1e-30)) - 7)
        else:
            ulp = np.spacing(np.maximum(np.abs(w), LR) if what == "params"
                             else np.abs(w))
        worst = max(worst, float((np.abs(g - w) / ulp).max()))
    return worst


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    r = _opt_parity(moment_dtype)
    assert r["steps"] == (6, 6)
    for i, what in enumerate(("params", "mu", "nu")):
        assert _ulps_apart(r["port"][i], r["ieee"][i], what) <= IEEE_ULPS, \
            what
        assert _ulps_apart(r["port"][i], r["jax"][i], what) <= ULPS, what


def test_train_step_matches_reference():
    """One whole step (loss, clip, AdamW) of each package from the same
    weights and batch, accum 1 and 2: the loss and the global gradient
    norm."""
    import jax
    from repro.configs import get_reduced as jax_reduced
    from repro.models import api as japi
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtrainer
    jcfg, cfg = jax_reduced("yi_6b"), C.get_reduced("yi_6b")
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, _jit(
        lambda k: japi.init_params(jcfg, k), key)(key))
    rng = np.random.default_rng(2)
    batch = dict(tokens=rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32), labels=rng.integers(0, cfg.vocab_size, (4, 16)).astype(
        np.int32))
    kw = dict(lr=1e-2, warmup=3)
    for accum in (1, 2):
        jo = jopt.AdamW(**kw)
        jstep = jtrainer.make_train_step(jcfg, jo, accum=accum,
                                         donate=False, jit=False)
        state = jo.init(params)
        _, _, jm = _jit(jstep, params, state, batch)(params, state, batch)
        po = AdamW(**kw)
        model = convert.from_reference(cfg, params, device="cpu")
        pm = make_train_step(cfg, po, accum=accum)(
            model, po.init(model),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(jm[k]),
                                                 rel=STEP_RTOL), (accum, k)


# ---------------------------------------------- JAX parity: the sampler
@pytest.mark.parametrize("pool", [128, 1024])
def test_sampler_capacity_matches_reference(pool, monkeypatch):
    """In float64 (the reference's x64, on in these tests; the port's
    ``enable_x64``) the capacities equal the reference's at eps 1e-4 and
    1e-6; in float32 (the card's dtype, the plain logcf here) the PGF is
    within ``PGF_ATOL`` of the reference's float64 one (measured 1.9e-7),
    too coarse to place a 1e-6 tail (module docstring of train/data.py)."""
    from repro.train.data import ProbabilisticSampler as JSampler
    from repro_torch.core import config
    probs = np.random.default_rng(pool).uniform(0.2, 0.9, pool)
    ref = JSampler(probs)
    want = np.asarray(ref.batch_size_pgf().coeffs)
    assert want.dtype == np.float64
    f32 = ProbabilisticSampler(probs, device="cpu").batch_size_pgf().coeffs
    assert f32.dtype == torch.float32 and f32.shape == want.shape
    np.testing.assert_allclose(f32.numpy(), want, rtol=0, atol=PGF_ATOL)
    monkeypatch.setitem(config._X64, "on", True)
    mine = ProbabilisticSampler(probs, device="cpu")
    assert mine.batch_size_pgf().coeffs.dtype == torch.float64
    for eps in (1e-4, 1e-6):
        assert mine.capacity_for(eps) == ref.capacity_for(eps), eps


# ----------------------------------------- JAX parity: compressed_psum
def _psum_rank(g, e):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((dist.get_world_size(),), ("pod",), backend="gloo",
                     device="cpu")
    r = dist.get_rank()
    return compressed_psum(g[r], e[r], mesh.axis("pod"))


def test_compressed_psum_matches_reference_over_4_ranks(tmp_path):
    import jax
    from repro.train.optimizer import compressed_psum as jpsum
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (4, 256)).astype(np.float32)
    e = rng.normal(0, 1e-3, (4, 256)).astype(np.float32)
    avg, err = jax.jit(jax.vmap(lambda a, b: jpsum(a, b, "pod"),
                                axis_name="pod"))(g, e)
    out = run_ranks(_psum_rank, 4, backend="gloo", device="cpu",
                    store_dir=tmp_path / "psum",
                    args=(torch.from_numpy(g), torch.from_numpy(e)))
    for r, (a, ne) in enumerate(out):
        assert torch.equal(a, out[0][0])          # every rank alike
        np.testing.assert_array_max_ulp(a.numpy(), np.asarray(avg[r]),
                                        maxulp=PSUM_ULPS)
        # the residual x - q * scale cancels: ulps of x (XLA may fuse it)
        tol = PSUM_ULPS * np.spacing(np.abs(g[r] + e[r]))
        assert np.all(np.abs(ne.numpy() - np.asarray(err[r])) <= tol)
    mean = (g + e).mean(0)
    assert float(np.abs(out[0][0].numpy() - mean).max()
                 / np.abs(mean).max()) < 0.05


# --------------------------------------- JAX parity: checkpoint format
def test_checkpoint_format_read_both_ways(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.train import checkpoint as jck
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "n": {"i": rng.integers(-9, 9, (7,)).astype(np.int32),
                  "s": np.asarray(4, np.int32)}}
    jck.save(str(tmp_path / "j"), 3, jax.tree.map(jnp.asarray, tree))
    like = {"w": torch.empty(3, 5), "n": {"i": torch.empty(7, dtype=
            torch.int32), "s": torch.empty((), dtype=torch.int32)}}
    got, manifest = ck.restore(str(tmp_path / "j"), 3, like)
    assert manifest["step"] == 3
    flat_like = ck.flatten(like)
    for k, v in ck.flatten(got).items():
        assert v.dtype == flat_like[k].dtype, k
        assert np.array_equal(v.numpy(), ck.flatten(tree)[k]), k

    ck.save(str(tmp_path / "p"), 4, {
        "w": torch.from_numpy(tree["w"]),
        "n": {k: torch.from_numpy(np.array(v)) for k, v in tree["n"].items()}})
    jlike = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         tree)
    back, jman = jck.restore(str(tmp_path / "p"), 4, jlike)
    assert jman["step"] == 4 and jman["process_count"] == 1
    for path, want in jax.tree_util.tree_leaves_with_path(tree):
        have = back
        for k in path:
            have = have[k.key]
        assert np.asarray(have).dtype == want.dtype
        assert np.array_equal(np.asarray(have), want)


def test_checkpoint_bfloat16_round_trip_is_bit_exact(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 33, generator=gen).to(torch.bfloat16)
    w[0, :4] = torch.tensor([float("inf"), float("-inf"), -0.0,
                             float("nan")])
    tree = {"params": {"w": w}, "opt": {"step": torch.tensor(
        3, dtype=torch.int32)}}
    ck.save(str(tmp_path), 1, tree)
    like = {"params": {"w": torch.empty(64, 33, dtype=torch.bfloat16)},
            "opt": {"step": torch.empty((), dtype=torch.int32)}}
    got, manifest = ck.restore(str(tmp_path), 1, like)
    assert manifest["dtypes"]["params/w"] == "bfloat16"
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       w.view(torch.int16))
    assert int(got["opt"]["step"]) == 3


# ------------------------------------------------------ entry points
def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "yi_6b", "--reduced", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] arch=yi_6b_smoke" in out and "over 3 steps" in out
    assert ck.latest_step(str(tmp_path)) == 3
    # a rerun resumes at the last checkpoint and has nothing to do
    assert launch_train.main(argv) == 0
    assert "already at step 3" in capsys.readouterr().out


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = C.get_reduced("yi_6b")
    stream = TokenStream(cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        stream.batch(0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(cfg, AdamW(), stream, str(tmp_path)).init_state()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ProbabilisticSampler(np.full(300, 0.5)).batch_size_pgf()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--arch", "yi_6b", "--reduced", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
