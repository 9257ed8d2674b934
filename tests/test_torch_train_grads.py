"""Gradients of the port's ``loss_fn`` against the JAX package's
``jax.value_and_grad(loss_fn)``, all ten architectures at their reduced
configs in float32 on the CPU, and the port's per-period remat against
no remat.

Both packages get the same numpy weights (the JAX tree carried by
``convert.from_reference``) and the same numpy tokens and labels.  The
JAX side runs under ``jax.jit`` without remat (``jax.checkpoint`` changes
where activations come from, not the math; it only lengthens the
compile).  The port's gradients are laid out as the reference's tree by
``convert.to_reference`` and compared leaf by leaf.

Bounds: the loss within ``LOSS_RTOL`` = 1e-5 relative; each leaf within
``GRAD_RTOL`` = 1e-4 of its scale, the larger of the leaf's own max
|g_ref| and ``ZERO_FLOOR`` = 1e-3 of the largest gradient of the model.
The floor is for a leaf whose exact gradient is zero, where both sides
return rounding noise: hubert's key bias ``bk`` (a softmax does not move
when every score of a query shifts by the same q . bk), ~1e-9 on both
sides against 0.107 for the head.  Measured on this CPU: the loss within
1.5e-7, every leaf within 2.5e-6 of its max (llama4's router; the others
below 1.3e-6), ``bk`` within 1.4e-9 absolute.  With the keys streamed
in three chunks (``CROSS_CHUNK``): the loss within 1.1e-7, every leaf
within 1.2e-5 (hubert), 1.4e-6 (recurrentgemma), 7.1e-7 (yi) of its
scale.  Remat on and off give the
same bits (loss and every gradient), since the recomputed forward runs
the same operations on the same inputs.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import api as japi
from repro_torch import configs as C
from repro_torch.models import api, convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_FLOOR = 1e-3
B, S = 2, 20

#: XLA CPU options of the reference's compiles (tests/test_torch_models.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=FAST_COMPILE)


def _inputs(cfg, rng):
    if cfg.embedding_inputs:
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return x, rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port(cfg, params, x, y, remat: bool):
    model = convert.from_reference(cfg, params, device="cpu")
    loss, _ = api.loss_fn(cfg, model, torch.from_numpy(x),
                          torch.from_numpy(y), remat=remat)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


def _reference(arch):
    jcfg, cfg = jax_reduced(arch), C.get_reduced(arch)
    x, y = _inputs(jcfg, np.random.default_rng(0))
    key = jax.random.PRNGKey(0)
    params = _jit(lambda k: japi.init_params(jcfg, k), key)(key)
    vg = _jit(lambda p, x, y: jax.value_and_grad(
        lambda q: japi.loss_fn(jcfg, q, x, y, remat=False)[0])(p),
        params, x, y)
    loss, grads = vg(params, x, y)
    params = jax.tree.map(np.asarray, params)
    return dict(cfg=cfg, x=x, y=y, params=params, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads),
                remat=_port(cfg, params, x, y, remat=True),
                plain=_port(cfg, params, x, y, remat=False))


@pytest.fixture(scope="module")
def ref():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = _reference(arch)
        return memo[arch]
    return get


def _assert_matches_reference(r):
    loss, grads = r["remat"]
    assert abs(float(loss) - r["loss"]) <= LOSS_RTOL * abs(r["loss"])
    got = convert.to_reference(r["cfg"], grads, r["grads"])
    leaves = jax.tree_util.tree_leaves_with_path(r["grads"])
    top = max(np.abs(g).max() for _, g in leaves)
    # every gradient of the port is in the comparison
    assert sum(g.size for _, g in leaves) == sum(g.numel()
                                                 for g in grads.values())
    for path, want in leaves:
        have = got
        for k in path:
            have = have[k.key]
        assert have.shape == want.shape, jax.tree_util.keystr(path)
        scale = max(np.abs(want).max(), ZERO_FLOOR * top)
        err = np.abs(have - want).max()
        assert err <= GRAD_RTOL * scale, (jax.tree_util.keystr(path), err,
                                          scale)


def _assert_remat_bit_equal(r):
    (l1, g1), (l2, g2) = r["remat"], r["plain"]
    assert torch.equal(l1, l2)
    assert g1.keys() == g2.keys()
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_loss_and_grads_match_reference(ref, arch):
    _assert_matches_reference(ref(arch))


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_remat_is_bit_equal(ref, arch):
    _assert_remat_bit_equal(ref(arch))


#: archs whose attention differs in its masks: causal GQA, bidirectional
#: with biases, and a local window (16) narrower than the sequence
CROSS_CHUNK_ARCHS = ("yi_6b", "hubert_xlarge", "recurrentgemma_2b")
CROSS_CHUNK = 8


@pytest.mark.parametrize("arch", CROSS_CHUNK_ARCHS)
def test_grads_across_kv_chunks_match_reference(monkeypatch, arch):
    """Both packages stream the keys in chunks of ``CROSS_CHUNK``, so the
    S = 20 keys take three chunks of 7 (the reference pads the last with
    one invalid slot): the running max's rescale and the causal and
    window masks cross chunk boundaries, in the forward and in the
    backward.  Same bounds as with one chunk, and remat bit-equal."""
    from repro.models import transformer as JT
    monkeypatch.setattr(JT, "_sdpa_streamed", functools.partial(
        JT._sdpa_streamed, chunk=CROSS_CHUNK))
    monkeypatch.setattr(T, "KV_CHUNK", CROSS_CHUNK)
    assert -(-S // CROSS_CHUNK) == 3
    r = _reference(arch)
    _assert_matches_reference(r)
    _assert_remat_bit_equal(r)


def test_rwkv_gradient_below_the_decay_clamp_matches_reference():
    """A channel whose cumulative log decay sinks below the -30 clamp
    inside a chunk takes no gradient through the clamped terms (the
    reference's ``jnp.maximum`` gives 0 there, ``torch.clamp_min`` too):
    the decay gradient equals the reference's, and is 0 from the step the
    clamp holds on."""
    from repro.models import rwkv6 as JRW
    from repro_torch.models import rwkv6 as RW
    rng = np.random.default_rng(0)
    b, t, h, k = 1, RW.CHUNK, 2, 4
    r, kk, v = (rng.normal(size=(b, t, h, k)).astype(np.float32)
                for _ in range(3))
    # channel 0 of head 0 decays by e^-1 a step: its cumulative log decay
    # passes -30 at step 30; the other channels decay slowly
    w = np.full((b, t, h, k), 0.99, np.float32)
    w[..., 0, 0] = np.exp(-1.0)
    u = np.zeros((h, k), np.float32)
    s0 = np.zeros((b, h, k, k), np.float32)
    want = np.asarray(jax.jit(jax.grad(
        lambda w: JRW._chunked_wkv(r, kk, v, w, u, s0)[0].sum()))(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    y, _ = RW.chunked_wkv(*(torch.from_numpy(a) for a in (r, kk, v)), wt,
                          torch.from_numpy(u), torch.from_numpy(s0))
    y.sum().backward()
    got = wt.grad.numpy()
    assert np.all(got[0, 30:, 0, 0] == 0) and np.all(want[0, 30:, 0, 0] == 0)
    assert np.all(got[0, :-1, 1] != 0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())


# ------------------------------------------- the card's attention products
def _bf16_pair(device, requires_grad=True):
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(3, 5, 8, generator=gen).to(torch.bfloat16)
    b = torch.randn(3, 8, 6, generator=gen).to(torch.bfloat16)
    return (a.to(device).requires_grad_(requires_grad),
            b.to(device).requires_grad_(requires_grad))


def test_bmm_f32_backward_on_meta():
    """The card's route (``aten::bmm.dtype``, which has no derivative)
    builds its backward through ``_BmmF32``: on ``meta`` tensors, where
    the op exists, the gradients come out in the inputs' shape and
    dtype."""
    a, b = _bf16_pair("meta")
    out = L.bmm_f32(a, b)
    assert out.dtype == torch.float32 and out.shape == (3, 5, 6)
    out.sum().backward()
    assert a.grad.shape == a.shape and a.grad.dtype == torch.bfloat16
    assert b.grad.shape == b.shape and b.grad.dtype == torch.bfloat16


def test_bmm_f32_without_autograd_calls_the_op(monkeypatch):
    """A product that autograd does not record (serving runs under
    ``no_grad``; inputs that need no gradient) calls the float32-out op
    directly, not through ``_BmmF32``; one that it records goes
    through it.  On ``meta``, where the card's op exists."""
    calls, real = [], L._BmmF32

    class Spy(real):
        @staticmethod
        def forward(ctx, a, b):
            calls.append(1)
            return real.forward(ctx, a, b)

    monkeypatch.setattr(L, "_BmmF32", Spy)
    a, b = _bf16_pair("meta", requires_grad=False)
    assert L.bmm_f32(a, b).dtype == torch.float32
    a, b = _bf16_pair("meta")
    with torch.no_grad():
        out = L.bmm_f32(a, b)
    assert out.dtype == torch.float32 and not out.requires_grad
    assert calls == []
    assert L.bmm_f32(a, b).requires_grad and calls == [1]


def test_bmm_f32_backward_values(monkeypatch):
    """``_BmmF32``'s backward math on the CPU, with the float32-out
    product (card-only) replaced by its upcast: the gradients equal
    autograd's through the upcast product of the bf16-rounded cotangent,
    rounded to bf16."""
    monkeypatch.setattr(L, "_mm_f32", lambda a, b: torch.bmm(a.float(),
                                                           b.float()))
    a, b = _bf16_pair("cpu")
    gen = torch.Generator().manual_seed(2)
    g = torch.randn(3, 5, 6, generator=gen)
    out = L._BmmF32.apply(a, b)
    assert torch.equal(out, torch.bmm(a.float(), b.float()))
    out.backward(g)
    a2, b2 = (t.detach().float().requires_grad_(True) for t in (a, b))
    torch.bmm(a2, b2).backward(g.to(torch.bfloat16).float())
    assert torch.equal(a.grad, a2.grad.to(torch.bfloat16))
    assert torch.equal(b.grad, b2.grad.to(torch.bfloat16))
