"""The LM mesh on gloo ranks, CPU, float32: the sharded train step
(``make_train_step`` on a ``sharding.ShardedModel`` under
``Rules(mesh, fsdp=True).activate()``), ``prefill`` under the same rules,
``checkpoint.save`` / ``restore(shardings=)``, ``train/elastic.py`` and
``db/distributed.py``'s ``shard_columns``.

Ranks are spawned once per rank count (2 and 4), side by side from
threads, while the JAX references compile in this process.  Reduced
yi_6b, olmoe_1b_7b and granite_34b (MQA: its one KV head is repeated to
the model axis, as the reference repeats it) take ``STEPS`` steps on meshes
(2, 1), (1, 2) and (2, 2) from the JAX package's initial weights
(carried by ``models/convert.py``), against

* the JAX package's unsharded ``make_train_step`` under ``jax.jit`` on
  the same numpy batches: loss and grad norm within ``RTOL`` relative,
  every updated parameter within ``PARAM_TOL`` of its leaf's scale;
* the port's one-rank step (computed on rank 0): the same bounds.

A leaf's scale is its max |p|, but at least ``PARAM_FLOOR`` of the
model's largest: a leaf that starts at zero (granite's attention biases)
holds nothing but two AdamW steps, each lr times m / sqrt(v), and that
ratio is noise-sensitive where an element's gradient is small (``bk``'s
is analytically zero: softmax shift invariance), so its own max |p|
(~2 lr) is no scale for it: the one-rank port against the JAX package
exceeds 1e-5 of it on ``bk``.  The same noise on weights of their own
scale is why ``OPT``'s lr is small: the gradients agree to rounding, but
two Adam steps at lr 1e-3 (olmoe's experts, the drop case) or 1e-4
(granite's ``w_out`` against the JAX package) amplify it past 1e-5 of
a leaf's max |p|.  Adam's step is m / (sqrt(v) + eps): for an element
whose gradient is near eps it moves by about lr g / eps, so rounding of
g is multiplied by lr / eps.  The parameter comparisons therefore leave
out the elements whose reference gradient lies within ``EPS_ZONE`` x eps
of zero, and not zero, at some step (the reference step's own gradients:
``Recording``; the tests print the count), and every gradient is
compared on its own, before the optimizer, within the bounds of
tests/test_torch_train_grads.py: each leaf within ``GRAD_RTOL`` of its
max |g| (floor ``ZERO_FLOOR`` of the model's largest).  The rule bites
on the model axis's split of the attention's output product (its
float32 parts summed over the ranks round otherwise than one product):
one element of olmoe's ``experts_out`` whose gradient is -1.2e-8 moves
1.4e-5 of the leaf's scale off the one-rank step on (1, 2).  The MoE drop
case (olmoe at capacity factor ``DROP_CF``) routes a batch on which each
rank routing its own rows would drop other tokens than the global routing
does; the mesh's drops equal one rank's.  Bit for bit on (2, 2): remat on
and off, a rerun, and a checkpoint saved under (2, 2), restored under
(1, 2), (1, 1) and (4, 1) and resharded back; a step after that restore
equals the uninterrupted run's step.  The card's own case is marked
``cuda``.

The JAX package is imported inside functions only: the ranks import this
module.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import configs as C
from repro_torch.models import api, convert
from repro_torch.testing.ranks import run_ranks
from repro_torch.train import checkpoint as ck
from repro_torch.train import elastic
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import make_train_step

ARCHS = ("yi_6b", "olmoe_1b_7b", "granite_34b")
SHAPES2 = ((2, 1), (1, 2))
SHAPES4 = ((2, 2),)
STEPS = 2
RTOL = 1e-6
PARAM_TOL = 1e-5
PARAM_FLOOR = 1e-2
OPT = dict(lr=3e-5, warmup=1)
EPS_ZONE = 10.0
#: tests/test_torch_train_grads.py's gradient bounds (that module imports
#: JAX at its top; this one is collected on the card, without JAX)
GRAD_RTOL = 1e-4
ZERO_FLOOR = 1e-3
DROP_CF = 1.0
BATCH = (4, 16)

#: XLA CPU options of the reference's compiles (tests/test_torch_models.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _cfg(arch, cf=None):
    cfg = C.get_reduced(arch)
    return dataclasses.replace(cfg, capacity_factor=cf) if cf else cfg


def _batches(arch, n=STEPS + 1, seed=0):
    cfg = C.get_reduced(arch)
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def _torch_batch(b, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@dataclasses.dataclass(frozen=True)
class Recording(AdamW):
    """AdamW that keeps a float32 copy of the gradients each update is
    handed (clipped, as the step hands them over): ``seen``, one dict a
    step."""
    seen: list = dataclasses.field(default_factory=list, compare=False)

    def update(self, grads, state, params):
        self.seen.append({k: g.detach().float().clone()
                          for k, g in grads.items()})
        return super().update(grads, state, params)


# ------------------------------------------------------------- the ranks
def _one_rank(cfg, params, batches, *, accum=1, remat=True,
              device="cpu"):
    """The port's unsharded step from ``params``: metrics, final
    parameters and each MoE layer's drops after the first step."""
    model = convert.from_reference(cfg, params, device=device)
    opt = Recording(**OPT)
    state = opt.init(model)
    step = make_train_step(cfg, opt, accum=accum, remat=remat)
    metrics, drops = [], None
    for b in batches:
        metrics.append({k: float(v) for k, v in
                        step(model, state, _torch_batch(b, device)).items()})
        if drops is None and cfg.n_experts:
            drops = [int(blk.ffn.dropped) for blk in model.layers]
    return dict(metrics=metrics, drops=drops,
                params={k: v.detach().cpu().clone()
                        for k, v in model.named_parameters()},
                grads=[{k: g.cpu() for k, g in s.items()}
                       for s in opt.seen])


def _sharded(cfg, params, shape, device="cpu", ranks=None):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import Rules, ShardedModel
    mesh = make_mesh(shape, ("data", "model"), backend="gloo", device=device,
                     ranks=ranks)
    rules = Rules(mesh, fsdp=True)
    return ShardedModel(convert.from_reference(cfg, params, device=device),
                        rules)


def _mesh_run(cfg, params, shape, batches, *, accum=1, remat=True,
              device="cpu"):
    """The sharded step on ``shape``: metrics, drops after the first step,
    the rules' layouts, the model and optimizer state."""
    sm = _sharded(cfg, params, shape, device)
    opt = Recording(**OPT)
    state = opt.init(sm)
    step = make_train_step(cfg, opt, accum=accum, remat=remat)
    metrics, drops = [], None
    with sm.rules.activate():
        for b in batches:
            m = step(sm, state, _torch_batch(b, device))
            metrics.append({k: float(v) for k, v in m.items()})
            if drops is None and cfg.n_experts:
                drops = [int(blk.ffn.dropped) for blk in sm.work.layers]
    return dict(metrics=metrics, drops=drops, layouts=dict(sm.rules.layouts),
                model=sm, opt=opt, state=state)


def _full(sm, keep: bool = True, blocks=None) -> dict | None:
    """The logical parameters (or of ``blocks``, a dict of this rank's
    blocks by parameter: its gradients), a collective: every rank calls
    it; kept where ``keep``."""
    blocks = sm.params if blocks is None else blocks
    full = {n: sm.shardings[n].gather(t).cpu() for n, t in blocks.items()}
    return full if keep else None


def _full_grads(r, keep: bool = True) -> list | None:
    """:func:`_full` of every step's gradients of a :func:`_mesh_run`."""
    grads = [_full(r["model"], keep, s) for s in r["opt"].seen]
    return grads if keep else None


def _per_rank_routing_drops(cfg, params, batch, n_data):
    """What each data rank routing only its own rows would drop (summed):
    the fault global routing prevents."""
    model = convert.from_reference(cfg, params, device="cpu")
    rows = BATCH[0] // n_data
    total = [0] * len(model.layers)
    with torch.no_grad():
        for r in range(n_data):
            tok = torch.from_numpy(batch["tokens"][r * rows:(r + 1) * rows])
            model(tok)
            total = [t + int(blk.ffn.dropped)
                     for t, blk in zip(total, model.layers)]
    return total


def _cases(world):
    return [(arch, shape) for arch in ARCHS
            for shape in (SHAPES2 if world == 2 else SHAPES4)]


def _rank(world, params, drop_params, batches, store):
    """Every case of this rank count; rank 0 also runs the one-rank
    references.  Returns what the tests read (full parameters from rank 0
    only)."""
    import torch.distributed as tdist
    rank = tdist.get_rank()
    out = {"cases": {}, "one": {}}
    for arch, shape in _cases(world):
        cfg = _cfg(arch)
        r = _mesh_run(cfg, params[arch], shape, batches[arch][:STEPS])
        out["cases"][(arch, shape)] = dict(
            metrics=r["metrics"], layouts=r["layouts"],
            params=_full(r["model"], rank == 0),
            grads=_full_grads(r, rank == 0))
    drop_cfg = _cfg("olmoe_1b_7b", DROP_CF)
    drop_batches = batches["olmoe_1b_7b"][:STEPS]
    for shape in (SHAPES2 if world == 2 else SHAPES4):
        r = _mesh_run(drop_cfg, drop_params, shape, drop_batches)
        out["cases"][("drops", shape)] = dict(
            metrics=r["metrics"], drops=r["drops"],
            params=_full(r["model"], rank == 0),
            grads=_full_grads(r, rank == 0),
            per_rank=_per_rank_routing_drops(
                drop_cfg, drop_params, drop_batches[0], shape[0])
            if rank == 0 else None)
    if rank == 0:
        for arch in ARCHS:
            out["one"][arch] = _one_rank(_cfg(arch), params[arch],
                                         batches[arch][:STEPS])
        out["one"]["drops"] = _one_rank(drop_cfg, drop_params, drop_batches)
    if world == 2:
        out.update(_rank2_extra(params, batches))
    else:
        out.update(_rank4_extra(params, batches, store))
    return out


def _rank2_extra(params, batches):
    """accum=2 on (2, 1); prefill under the rules; the mesh makers."""
    import torch.distributed as tdist
    from repro_torch.launch import mesh as M
    rank = tdist.get_rank()
    cfg = _cfg("yi_6b")
    r = _mesh_run(cfg, params["yi_6b"], (2, 1), batches["yi_6b"][:STEPS],
                  accum=2)
    out = {"accum": dict(metrics=r["metrics"],
                         params=_full(r["model"], rank == 0))}
    if rank == 0:
        out["accum_one"] = _one_rank(cfg, params["yi_6b"],
                                     batches["yi_6b"][:STEPS], accum=2)
    prefill = {}
    for arch in ("yi_6b", "olmoe_1b_7b"):
        cfg = _cfg(arch)
        tok = torch.from_numpy(batches[arch][0]["tokens"])
        sm = _sharded(cfg, params[arch], (2, 1))
        with sm.rules.activate():
            got = api.prefill(cfg, sm, tok)
        want = api.prefill(cfg, convert.from_reference(cfg, params[arch],
                                                       device="cpu"), tok)
        prefill[arch] = float((got - want).abs().max()
                              / want.abs().max())
    out["prefill"] = prefill
    out["backward_thread"] = _backward_in_a_thread(params)
    try:
        M.make_production_mesh(backend="gloo", device="cpu")
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    out["host_mesh"] = dict(M.make_host_mesh(backend="gloo",
                                             device="cpu").shape)
    return out


def _backward_in_a_thread(params):
    """olmoe on (2, 1) with remat: the backward run from another thread
    (as autograd runs a CUDA backward on its device threads) recomputes
    each period under the forward's rules, and gives the gradients of a
    backward in this thread."""
    import threading
    from repro_torch.sharding import place_batch
    cfg = _cfg("olmoe_1b_7b")
    b = _batches("olmoe_1b_7b")[0]
    sm = _sharded(cfg, params["olmoe_1b_7b"], (2, 1))
    sm.gather_()
    grads = []
    for threaded in (False, True):
        with sm.rules.activate():
            loss, _ = api.loss_fn(
                cfg, sm.work, place_batch(sm.rules, torch.from_numpy(
                    b["tokens"])), place_batch(sm.rules, torch.from_numpy(
                        b["labels"])), remat=True)
        if threaded:
            errors = []

            def run():
                try:
                    loss.backward()
                except Exception as e:          # reported to the test
                    errors.append(repr(e))
            t = threading.Thread(target=run)
            t.start()
            t.join(120)
            if errors or t.is_alive():
                return errors or ["the backward thread hung"]
        else:
            loss.backward()
        grads.append({n: p.grad.clone() for n, p in
                      sm.work.named_parameters()})
        sm.work.zero_grad(set_to_none=True)
    return [n for n in grads[0] if not torch.equal(grads[0][n],
                                                   grads[1][n])]


def _rank4_extra(params, batches, store):
    """Remat and rerun bits; the checkpoint round trip and the step after
    it; degrade_mesh; shard_columns."""
    import torch.distributed as tdist
    from repro_torch.db import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import Rules, state_shardings
    rank = tdist.get_rank()
    cfg = _cfg("yi_6b")
    p, bs = params["yi_6b"], batches["yi_6b"]
    a = _mesh_run(cfg, p, (2, 2), bs[:STEPS])
    b = _mesh_run(cfg, p, (2, 2), bs[:STEPS])
    c = _mesh_run(cfg, p, (2, 2), bs[:STEPS], remat=False)

    def same(x, y):
        return all(torch.equal(x["model"].params[n], y["model"].params[n])
                   and torch.equal(x["state"].mu[n], y["state"].mu[n])
                   for n in x["model"].params) \
            and x["metrics"] == y["metrics"]
    out = {"rerun_equal": same(a, b), "remat_equal": same(a, c)}

    # the checkpoint under (2, 2), restored under three other meshes and
    # resharded back
    sm, state = a["model"], a["state"]
    tree = sm.tree(state)
    saved = ck.flatten(tree)
    saved = {k: v.local.clone() for k, v in saved.items()}
    ck.save(str(store / "ckpt"), STEPS, tree, extra={"mesh": [2, 2]})
    restored = {}
    for shape, ranks in (((1, 2), [0, 1]), ((1, 1), [0]), ((4, 1), None)):
        mesh = make_mesh(shape, ("data", "model"), backend="gloo",
                         device="cpu", ranks=ranks)
        placed, _ = ck.restore(str(store / "ckpt"), STEPS, tree,
                               shardings=state_shardings(Rules(mesh), cfg))
        back = ck.flatten(elastic.reshard(placed, sm.rules))
        restored[shape] = all(torch.equal(back[k].local, saved[k])
                              for k in saved)
    out["restored_equal"] = restored
    # a step after the (4, 1) restore (the last ``placed``) equals the
    # uninterrupted run's
    fresh = _sharded(cfg, p, (2, 2))
    opt = AdamW(**OPT)
    fstate = opt.init(fresh)
    fresh.load_(elastic.reshard(placed, fresh.rules), fstate)
    step = make_train_step(cfg, opt)
    m1 = step(fresh, fstate, _torch_batch(bs[STEPS]))
    m0 = step(sm, state, _torch_batch(bs[STEPS]))
    out["step_after_restore_equal"] = bool(
        all(torch.equal(fresh.params[n], sm.params[n])
            and torch.equal(fstate.nu[n], state.nu[n]) for n in sm.params)
        and int(fstate.step) == int(state.step) == STEPS + 1
        and float(m0["loss"]) == float(m1["loss"]))

    # degrade_mesh over three survivors: (1, 2) on ranks 0, 1
    dm = elastic.degrade_mesh([0, 1, 2], backend="gloo", device="cpu")
    out["degrade"] = dict(shape=dict(dm.shape), ranks=list(dm.ranks),
                          coords=dm.coords,
                          batch=elastic.scale_batch(8, dm)
                          if dm.coords is not None else None)

    # shard_columns on (2, 2) and on (pod 2, data 2, model 1)
    cols = [np.arange(16, dtype=np.float32), np.arange(16, dtype=np.int32)]
    blocks = {}
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 1), ("pod", "data", "model"))):
        mesh = make_mesh(shape, names, backend="gloo", device="cpu")
        blocks[names] = [t.numpy() for t in D.shard_columns(mesh, cols)]
    out["columns"] = blocks
    return out


# ------------------------------------------------------- the references
def _jit(f, *args):
    import jax
    return jax.jit(f).lower(*args).compile(compiler_options=FAST_COMPILE)


def _jax_init(arch):
    import jax
    from repro.configs import get_reduced as jax_reduced
    from repro.models import api as japi
    jcfg = jax_reduced(arch)
    key = jax.random.PRNGKey(0)
    return jax.tree.map(np.asarray, _jit(
        lambda k: japi.init_params(jcfg, k), key)(key))


def _jax_grads_fn(jcfg, params, batch):
    """The reference's clipped gradients of one unsharded step (what its
    optimizer is handed), jitted: ``fn(params, batch)``."""
    import jax
    from repro.models import api as japi
    from repro.train import optimizer as jopt

    def grads(p, b):
        g = jax.grad(lambda q: japi.loss_fn(jcfg, q, b["tokens"],
                                            b["labels"], remat=False)[0])(p)
        return jopt.clip_by_global_norm(g, 1.0)[0]
    return _jit(grads, params, batch)


def _jax_steps(arch, params, batches, accum=1, jcfg=None):
    """The reference's unsharded jitted step from ``params`` over the
    batches: (metrics per step, final parameters as numpy, and with
    ``accum`` 1 each step's clipped gradients as numpy trees)."""
    import jax
    from repro.configs import get_reduced as jax_reduced
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtrainer
    jcfg = jcfg or jax_reduced(arch)
    jo = jopt.AdamW(**OPT)
    step = jtrainer.make_train_step(jcfg, jo, accum=accum, donate=False,
                                    jit=False)
    state = jo.init(params)
    fn = _jit(step, params, state, batches[0])
    gfn = _jax_grads_fn(jcfg, params, batches[0]) if accum == 1 else None
    metrics, grads = [], []
    for b in batches:
        if gfn is not None:
            grads.append(jax.tree.map(np.asarray, gfn(params, b)))
        params, state, m = fn(params, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, params), grads or None


JAX_COLUMNS = '''
import json
import jax, numpy as np
from repro.compat import make_mesh
from repro.db import distributed as D
cols = [np.arange(16, dtype=np.float32), np.arange(16, dtype=np.int32)]
for shape, names in (((2, 2), ("data", "model")),
                     ((2, 2, 1), ("pod", "data", "model"))):
    mesh = make_mesh(shape, names)
    out = D.shard_columns(mesh, cols)
    for i, d in enumerate(mesh.devices.reshape(-1)):
        for a in out:
            sh = [s for s in a.addressable_shards if s.device == d][0]
            print(json.dumps([names[0], i, np.asarray(sh.data).tolist()]))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns (threads), the JAX references meanwhile."""
    from concurrent.futures import ThreadPoolExecutor
    from conftest import run_sub
    params = {a: _jax_init(a) for a in ARCHS}
    batches = {a: _batches(a) for a in ARCHS}
    # (made here, not in the threads: the first mktemp creates the base)
    dirs = {w: tmp_path_factory.mktemp(f"mesh_train{w}") for w in (2, 4)}
    with ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(
            run_ranks, _rank, w, backend="gloo", device="cpu",
            store_dir=dirs[w] / "store", timeout=240,
            args=(w, params, params["olmoe_1b_7b"], batches, dirs[w]))
            for w in (2, 4)}
        ref = {a: _jax_steps(a, params[a], batches[a][:STEPS])
               for a in ARCHS}
        ref["accum"] = _jax_steps("yi_6b", params["yi_6b"],
                                  batches["yi_6b"][:STEPS], accum=2)
        columns = run_sub(JAX_COLUMNS, devices=4)
        out = {w: f.result() for w, f in futs.items()}
    return dict(ranks=out, ref=ref, params=params, columns=columns)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _np(v):
    return np.asarray(v.detach() if hasattr(v, "detach") else v, np.float32)


def _settled(grads, k):
    """Where the reference's gradient of leaf ``k`` is zero or at least
    ``EPS_ZONE`` x Adam's eps from zero at every step of ``grads`` (a list
    of dicts by leaf): the elements whose update rounding does not
    magnify (module docstring; a zero gradient moves neither side)."""
    eps = EPS_ZONE * AdamW.eps
    return np.all([(a == 0) | (a >= eps)
                   for a in (np.abs(_np(g[k])) for g in grads)], axis=0)


def _leaf_errs(got: dict, want: dict, grads=None) -> dict:
    """{leaf: max |got - want| over its scale} (module docstring); the
    leaves as numpy arrays or tensors, by any key.  With ``grads`` (the
    reference's gradients, one dict a step, by the same keys) only the
    elements :func:`_settled` keeps count."""
    want = {k: _np(v) for k, v in want.items()}
    floor = PARAM_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    out = {}
    for k, w in want.items():
        d = np.abs(_np(got[k]) - w)
        if grads is not None:
            d = np.where(_settled(grads, k), d, 0.0)
        out[k] = float(d.max() / max(float(np.abs(w).max()), floor))
    return out


def _left_out(grads) -> dict:
    """{leaf: elements :func:`_settled` leaves out}, where any."""
    out = {k: int((~_settled(grads, k)).sum()) for k in grads[0]}
    return {k: n for k, n in out.items() if n}


def _flat(cfg, got: dict, want_tree):
    """({leaf: got's}, {leaf: want's}) by the reference tree's paths."""
    import jax
    got_tree = convert.to_reference(cfg, got, want_tree)
    g_out, w_out = {}, {}
    for path, w in jax.tree_util.tree_leaves_with_path(want_tree):
        g = got_tree
        for k in path:
            g = g[k.key]
        key = jax.tree_util.keystr(path)
        g_out[key], w_out[key] = g, w
    return g_out, w_out


def _flat_ref(tree) -> dict:
    import jax
    return {jax.tree_util.keystr(p): w
            for p, w in jax.tree_util.tree_leaves_with_path(tree)}


def _param_err(cfg, got: dict, want_tree, grads=None) -> float:
    """The worst leaf of :func:`_leaf_errs` against a reference tree
    (``grads``: the reference's gradient trees, one a step)."""
    g, w = _flat(cfg, got, want_tree)
    if grads is not None:
        grads = [_flat_ref(t) for t in grads]
        print("left out of the parameter comparison:", _left_out(grads))
    return max(_leaf_errs(g, w, grads).values())


def _params_close(got: dict, want: dict, what, grads=None):
    if grads is not None:
        print(what, "left out of the parameter comparison:",
              _left_out(grads))
    errs = _leaf_errs(got, want, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= PARAM_TOL, (what, worst, errs[worst])


def _grad_errs(got: dict, want: dict) -> dict:
    """{leaf: max |got - want| over its scale}: the leaf's max |want|, at
    least ``ZERO_FLOOR`` of the model's largest (the bounds of
    tests/test_torch_train_grads.py)."""
    want = {k: _np(v) for k, v in want.items()}
    floor = ZERO_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(_np(got[k]) - w).max()
                     / max(float(np.abs(w).max()), floor))
            for k, w in want.items()}


def _grads_close(got: list, want: list, what, cfg=None):
    """Every step's gradients within ``GRAD_RTOL`` of the reference's:
    dicts by parameter, or (with ``cfg``) the reference's trees."""
    assert got and len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        if cfg is not None:
            g, w = _flat(cfg, g, w)
        errs = _grad_errs(g, w)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_RTOL, (what, i, worst, errs[worst])


def _metrics_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            assert _rel(g[k], w[k]) <= RTOL, (what, i, k, g[k], w[k])


ALL_CASES = [(a, s) for a in ARCHS for s in SHAPES2 + SHAPES4]


def _case(runs, arch, shape):
    world = shape[0] * shape[1]
    return runs["ranks"][world], runs["ranks"][world][0]["cases"][
        (arch, shape)]


@pytest.mark.parametrize("arch,shape", ALL_CASES)
def test_mesh_step_matches_reference(runs, arch, shape):
    """Loss and grad norm of every step within RTOL of the JAX package's
    unsharded jitted step; every rank reports the same numbers."""
    ranks, case = _case(runs, arch, shape)
    _metrics_close(case["metrics"], runs["ref"][arch][0], (arch, shape))
    for r in ranks[1:]:
        assert r["cases"][(arch, shape)]["metrics"] == case["metrics"]


@pytest.mark.parametrize("arch,shape", ALL_CASES)
def test_mesh_params_match_reference(runs, arch, shape):
    _, case = _case(runs, arch, shape)
    ref = runs["ref"][arch]
    err = _param_err(_cfg(arch), case["params"], ref[1], ref[2])
    assert err <= PARAM_TOL, err


@pytest.mark.parametrize("arch,shape", ALL_CASES)
def test_mesh_step_matches_one_rank(runs, arch, shape):
    ranks, case = _case(runs, arch, shape)
    one = ranks[0]["one"][arch]
    _metrics_close(case["metrics"], one["metrics"], (arch, shape))
    _params_close(case["params"], one["params"], (arch, shape), one["grads"])


@pytest.mark.parametrize("arch,shape", ALL_CASES)
def test_mesh_grads_match_reference(runs, arch, shape):
    """Every step's gradients, before the optimizer, within ``GRAD_RTOL``
    of the JAX package's."""
    _, case = _case(runs, arch, shape)
    _grads_close(case["grads"], runs["ref"][arch][2], (arch, shape),
                 _cfg(arch))


@pytest.mark.parametrize("arch,shape", ALL_CASES)
def test_mesh_grads_match_one_rank(runs, arch, shape):
    ranks, case = _case(runs, arch, shape)
    _grads_close(case["grads"], ranks[0]["one"][arch]["grads"],
                 (arch, shape))


@pytest.mark.parametrize("arch,shape", ALL_CASES)
def test_attention_layout_first_fit(runs, arch, shape):
    """The recorded first fit is the reference's: KV heads over ``model``
    where they divide it after the reference's transient repeat (granite's
    one KV head is repeated to the model axis's size on (1, 2) and (2, 2),
    as ``repro/models/transformer.py`` repeats it), else the query time;
    and only the reference's activation names were recorded."""
    from repro_torch.sharding import Rules
    _, case = _case(runs, arch, shape)
    lay = case["layouts"]
    cfg = C.get_reduced(arch)
    kv, h, m = cfg.n_kv_heads, cfg.n_heads, shape[1]
    if kv % m and h % m == 0:
        kv = next(kv * r for r in range(2, h // kv + 1)
                  if (kv * r) % m == 0 and h % (kv * r) == 0)
    want = ("data", None, "model", None, None) if kv % m == 0 \
        else ("data", "model", None, None, None)
    assert lay["first_fit"] == want
    assert set(lay) - {"first_fit"} <= set(Rules.ACT_RULES)


@pytest.mark.parametrize("shape", SHAPES2 + SHAPES4)
def test_moe_drops_equal_one_rank(runs, shape):
    """Global routing on the mesh: each MoE layer drops what one rank
    drops, on a batch where per-rank routing would drop otherwise; the
    step stays within the bounds of the one-rank step."""
    world = shape[0] * shape[1]
    ranks = runs["ranks"][world]
    case = ranks[0]["cases"][("drops", shape)]
    one = ranks[0]["one"]["drops"]
    assert all(d > 0 for d in one["drops"]), one["drops"]
    for r in ranks:
        assert r["cases"][("drops", shape)]["drops"] == one["drops"]
    if shape[0] > 1:
        assert case["per_rank"] != one["drops"], case["per_rank"]
    _metrics_close(case["metrics"], one["metrics"], ("drops", shape))
    _params_close(case["params"], one["params"], ("drops", shape),
                  one["grads"])
    _grads_close(case["grads"], one["grads"], ("drops", shape))


def test_accum_on_2x1(runs):
    """accum=2 (each global microbatch split over the data axis): within
    the bounds of the one-rank accum=2 step and of the JAX package's."""
    r = runs["ranks"][2][0]
    _metrics_close(r["accum"]["metrics"], r["accum_one"]["metrics"],
                   "accum one-rank")
    _metrics_close(r["accum"]["metrics"], runs["ref"]["accum"][0],
                   "accum jax")
    err = _param_err(_cfg("yi_6b"), r["accum"]["params"],
                     runs["ref"]["accum"][1])
    assert err <= PARAM_TOL, err


def test_prefill_under_rules(runs):
    """prefill of a ShardedModel on (2, 1): every rank gets the global
    logits, within float rounding of one rank's (the MoE routed
    globally)."""
    for r in runs["ranks"][2]:
        for arch, err in r["prefill"].items():
            assert err <= RTOL, (arch, err)


def test_backward_from_another_thread(runs):
    """The recomputation of a remat segment sees the forward's rules
    whichever thread runs the backward: no error, the same gradients."""
    for r in runs["ranks"][2]:
        assert r["backward_thread"] == []


def test_remat_and_rerun_bit_equal_on_2x2(runs):
    for r in runs["ranks"][4]:
        assert r["rerun_equal"] and r["remat_equal"]


def test_checkpoint_restore_reshard_roundtrip(runs):
    """Saved under (2, 2); restore(shardings=) under (1, 2), one rank and
    (4, 1); resharded to (2, 2): every leaf bit-equal to the saved block
    on every rank."""
    for r in runs["ranks"][4]:
        assert r["restored_equal"] == {(1, 2): True, (1, 1): True,
                                       (4, 1): True}


def test_step_after_restore_bit_equal(runs):
    for r in runs["ranks"][4]:
        assert r["step_after_restore_equal"]


def test_mesh_makers(runs):
    r2, r4 = runs["ranks"][2], runs["ranks"][4]
    assert all("256" in r["production"] for r in r2)
    assert all(r["host_mesh"] == {"data": 1, "model": 2} for r in r2)
    for rank, r in enumerate(r4):
        d = r["degrade"]
        assert d["shape"] == {"data": 1, "model": 2} and d["ranks"] == [0, 1]
        if rank < 2:
            assert d["coords"] == {"data": 0, "model": rank}
            assert d["batch"] == 8
        else:
            assert d["coords"] is None


def test_shard_columns_match_reference(runs):
    """Each rank's row block equals the JAX package's block on the device
    at the same row-major mesh position."""
    import json
    want = {}
    for line in runs["columns"].splitlines():
        head, i, block = json.loads(line)
        want.setdefault((head, i), []).append(block)
    assert len(want) == 8
    for rank, r in enumerate(runs["ranks"][4]):
        for names, blocks in r["columns"].items():
            got = [b.tolist() for b in blocks]
            assert got == want[(names[0], rank)], (names, rank)


@pytest.mark.parametrize("n", range(1, 18))
def test_degrade_shape_matches_reference(n, monkeypatch):
    """The reference's degrade_mesh arithmetic over n devices (its Mesh
    stood in for, since this process has one device)."""
    from repro.train import elastic as jel
    monkeypatch.setattr(jel, "Mesh", lambda devs, names: devs.shape)
    data, model = jel.degrade_mesh(list(range(n)))
    assert elastic.degrade_shape(n) == (data, model)
    assert elastic.degrade_shape(n, prefer_model=2) == \
        tuple(jel.degrade_mesh(list(range(n)), prefer_model=2))


def test_scale_batch_matches_reference():
    from repro.train import elastic as jel

    class FakeMesh:
        def __init__(self, names, shape):
            self.axis_names, self.shape = names, dict(zip(names, shape))
    for names, shape in ((("data", "model"), (4, 2)),
                         (("pod", "data", "model"), (2, 2, 4)),
                         (("model",), (8,))):
        m = FakeMesh(names, shape)
        assert elastic.scale_batch(64, m) == jel.scale_batch(64, m)
    with pytest.raises(ValueError):
        elastic.scale_batch(6, FakeMesh(("data",), (4,)))


# ------------------------------------------------------------- the card
def _card_rank(params, batches):
    cfg = _cfg("yi_6b")
    r = _mesh_run(cfg, params, (2, 1), batches, device="cuda")
    again = _mesh_run(cfg, params, (2, 1), batches, device="cuda")
    same = all(torch.equal(r["model"].params[n], again["model"].params[n])
               for n in r["model"].params)
    return dict(metrics=r["metrics"], params=_full(r["model"]), same=same)


@pytest.mark.cuda
def test_mesh_step_on_the_card(tmp_path):
    """Two gloo ranks sharing the card, reduced yi_6b (float32, the
    initial weights drawn on the CPU): within the bounds of one rank on
    the card, and a rerun bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = _cfg("yi_6b")
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = convert.to_reference(
        cfg, dict(model.named_parameters()),
        convert.reference_shapes(cfg))
    batches = _batches("yi_6b")[:STEPS]
    out = run_ranks(_card_rank, 2, backend="gloo", device="cuda",
                    store_dir=tmp_path / "store", args=(params, batches))
    one = _one_rank(cfg, params, batches, device="cuda")
    for r in out:
        assert r["same"]
        _metrics_close(r["metrics"], one["metrics"], "card")
        _params_close(r["params"], one["params"], "card")


def test_input_specs_match_reference():
    """db/distributed.py's stand-ins: the reference's shapes and dtypes,
    as ``meta`` tensors."""
    from repro.db import distributed as jd
    from repro_torch.db import distributed as D
    want = jd.input_specs(n_tuples=96)
    got = D.input_specs(n_tuples=96)
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape)
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
        assert got[k].device.type == "meta"
    assert D.input_specs(n_tuples=8, dtype=torch.float64)["probs"].dtype \
        == torch.float64
