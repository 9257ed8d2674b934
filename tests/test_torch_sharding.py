"""The port's sharding rule table (``repro_torch.sharding``) on the CPU,
pure Python, no ranks: the reference's tests/test_sharding.py cases
ported, and the table held equal to the JAX package's for every leaf of
the ten reduced architectures (``jax.eval_shape`` of the reference's
``init_params``) on fake meshes (1, 1), (4, 16), (2, 2) and
(2, 16, 16) with ``pod``, for ``fsdp`` and ``sp`` on and off: the
reference's spec of a leaf path, the port's placement of every parameter
of a port ``Model`` (that spec without the stacked period dim, reversed
for an ``nn.Linear`` weight), the activation specs, the input shardings
and the first-fit attention layout.  A JAX ``PartitionSpec`` compares
equal to the port's tuple (both write a one-name tuple as the name)."""
import math

import pytest
import torch

from repro_torch import configs as C
from repro_torch import sharding
from repro_torch.launch.mesh import host_mesh_shape
from repro_torch.models import convert
from repro_torch.models.api import Model
from repro_torch.sharding import P, Rules, _spec_fits


class FakeMesh:
    """A mesh's shape without ranks (the reference tests' stand-in)."""

    def __init__(self, names=("data", "model"), shape=(4, 16)):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = {"1x1": (("data", "model"), (1, 1)),
          "4x16": (("data", "model"), (4, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module")
def mesh():
    return FakeMesh(shape=(1, 1))


# ------------------------------------------ the reference's cases, ported
def test_param_rules_shard_matching_dims(mesh):
    r = Rules(mesh, fsdp=True)
    # 1x1 mesh: every axis has size 1, divisibility always holds
    assert r.param_spec("blocks/0/mixer/wq", (64, 128)) == P("data", "model")
    assert r.param_spec("blocks/0/mixer/wo", (128, 64)) == P("model", "data")
    assert r.param_spec("blocks/0/norm1/gamma", (64,)) == P()
    assert r.param_spec("embed", (512, 64)) == P("model", "data")
    assert r.param_spec("blocks/0/ffn/experts_in", (8, 64, 96)) == \
        P("model", "data", None)


def test_param_rules_drop_non_dividing_axes():
    r = Rules(FakeMesh(shape=(4, 16)), fsdp=True)
    assert r.param_spec("blocks/0/mixer/wk", (64, 4 * 7)) == P("data", None)
    assert r.param_spec("blocks/0/mixer/wk", (63, 32)) == P(None, "model")


def test_stacked_leading_dim_gets_none(mesh):
    r = Rules(mesh)
    assert r.param_spec("blocks/0/mixer/wq", (4, 64, 128)) == \
        P(None, "data", "model")


def test_fsdp_off_drops_dp(mesh):
    r = Rules(mesh, fsdp=False)
    assert r.param_spec("blocks/0/mixer/wq", (64, 128)) == P(None, "model")


def test_spec_fits():
    m = FakeMesh(shape=(4, 16))
    assert _spec_fits(m, P(None, "model"), (3, 32))
    assert not _spec_fits(m, P(None, "model"), (3, 31))
    assert not _spec_fits(m, P("pod", None), (8, 8))
    assert _spec_fits(m, (("data",), "model"), (8, 16))


def test_constrain_noop_outside_context():
    x = torch.ones((4, 4))
    assert sharding.constrain(x, "residual") is x
    assert sharding.constrain_first_fit(x, [P("model", None)]) is x
    from repro_torch.models import layers as L
    assert L.constrain(x, "residual") is x
    assert L.constrain_first_fit(x, [P("model", None)]) is x


def test_act_spec_sp_mode(mesh):
    assert Rules(mesh, sp=True).act_spec("residual")[2] == "model"
    assert Rules(mesh, sp=False).act_spec("residual")[2] is None


# ------------------------------------------------ parity with the JAX table
@pytest.fixture(scope="module")
def reference_trees():
    """Every reduced arch's reference parameter tree of shapes."""
    import jax
    from repro.configs import base as jc
    from repro.models import api as japi
    out = {}
    for arch in jc.ARCH_IDS:
        jcfg = jc.get_reduced(arch)
        out[arch] = jax.eval_shape(
            lambda c=jcfg: japi.init_params(c, jax.random.PRNGKey(0)))
    return out


def _jax_rules(names, shape, **kw):
    from repro.sharding import Rules as JRules
    return JRules(FakeMesh(names, shape), **kw)


def _flags():
    return [dict(fsdp=f, sp=s) for f in (True, False) for s in (True, False)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_param_table_matches_reference(arch, mesh_name, reference_trees):
    """The port's spec of every reference leaf equals the JAX table's, and
    the port's placement of every parameter of a port Model is that spec
    without the period dim, reversed for a Linear weight."""
    import jax
    names, shape = MESHES[mesh_name]
    tree = reference_trees[arch]
    shapes = jax.tree.map(lambda l: tuple(l.shape), tree)
    cfg = C.get_reduced(arch)
    assert convert.reference_shapes(cfg) == shapes
    for kw in _flags():
        mine, ref = Rules(FakeMesh(names, shape), **kw), \
            _jax_rules(names, shape, **kw)
        placed = mine.model_shardings(cfg)
        seen = set()
        for path, period, name, transposed in convert._pairs(cfg, shapes):
            leaf = convert._get(shapes, path)
            want = tuple(ref.param_spec("/".join(path), leaf))
            assert mine.param_spec("/".join(path), leaf) == want, path
            want = want + (None,) * (len(leaf) - len(want))
            if period is not None:
                want = want[1:]
            if transposed:
                want = want[::-1]
            assert placed[name].spec == want, (name, kw)
            seen.add(name)
        model = Model(cfg, device="meta")
        assert seen == set(placed) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_activation_specs_match_reference(mesh_name, monkeypatch):
    """act_spec of every name and input_sharding at dividing and
    non-dividing shapes, equal to the JAX package's."""
    from repro import sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    names, shape = MESHES[mesh_name]
    for kw in _flags():
        mine, ref = Rules(FakeMesh(names, shape), **kw), \
            _jax_rules(names, shape, **kw)
        for name in Rules.ACT_RULES:
            assert mine.act_spec(name) == tuple(ref.act_spec(name)), name
        for name, shp in (("tokens", (32, 128)), ("tokens", (6, 128)),
                          ("tokens", (1, 8)), ("residual", (32, 16, 64)),
                          ("residual", (32, 16, 48)), ("logits", (4, 8, 96)),
                          ("heads", (64, 8, 4, 16))):
            got = mine.input_sharding(name, shp)
            assert got.spec == tuple(ref.input_sharding(name, shp)), \
                (name, shp, kw)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["yi_6b", "granite_34b", "chatglm3_6b"])
def test_first_fit_attention_layout(arch, mesh_name):
    """The attention site's first fit (KV heads over ``model``, else the
    query time), on the logical shape of a rank's rows: the choice the
    reference's ``_spec_fits`` makes, recorded in ``rules.layouts``."""
    from repro.sharding import _spec_fits as jfits
    names, shape = MESHES[mesh_name]
    fake = FakeMesh(names, shape)
    cfg = C.get_config(arch)
    rules = Rules(fake)
    n_dp = math.prod(fake.shape[a] for a in rules.dp)
    g = cfg.n_heads // cfg.n_kv_heads
    local = (2, 64, cfg.n_kv_heads, g, cfg.resolved_head_dim)
    logical = (2 * n_dp,) + local[1:]
    specs = [P(rules.dp, None, "model", None, None),
             P(rules.dp, "model", None, None, None)]
    want = next((s for s in specs if jfits(fake, s, logical)), None)
    x = torch.empty(local, device="meta")
    with rules.activate():
        assert sharding.constrain_first_fit(x, specs) is x
    assert rules.layouts["first_fit"] == want
    if arch == "granite_34b" and fake.shape["model"] > 1:
        assert want == specs[1]                  # one KV head: query time


def test_yi_kv_heads_fall_to_query_time_on_model_8():
    rules = Rules(FakeMesh(shape=(2, 8)))
    cfg = C.get_config("yi_6b")
    x = torch.empty((1, 4096, 4, 8, 128), device="meta")
    specs = [P(rules.dp, None, "model", None, None),
             P(rules.dp, "model", None, None, None)]
    with rules.activate():
        sharding.constrain_first_fit(x, specs)
    assert cfg.n_kv_heads == 4
    assert rules.layouts["first_fit"] == ("data", "model", None, None, None)


def test_constrain_records_the_sites_spec():
    rules = Rules(FakeMesh(shape=(2, 2)), sp=True)
    x = torch.ones(2, 3, 4)
    with rules.activate():
        assert sharding.constrain(x, "residual") is x
        assert sharding.current_rules() is rules
        assert sharding.current_dp() == ("data",)
    assert sharding.current_rules() is None and sharding.current_dp() == ()
    assert rules.layouts == {"residual": ("data", None, "model")}


def test_expert_axis_follows_the_rule():
    cfg = C.get_config("olmoe_1b_7b")                  # 64 experts
    assert Rules(FakeMesh(shape=(2, 16))).expert_axis(cfg) == "model"
    assert Rules(FakeMesh(shape=(2, 3))).expert_axis(cfg) is None


def test_params_tree_of_a_reference_tree(reference_trees):
    import jax
    shapes = reference_trees["olmoe_1b_7b"]
    rules = Rules(FakeMesh(shape=(2, 2)))
    tree = rules.params_tree(jax.tree.map(
        lambda l: torch.empty(l.shape, device="meta"), shapes))
    sh = tree["blocks"]["0"]["ffn"]["experts_in"]
    assert sh.spec == (None, "model", "data", None)
    assert sh.rule[0] == "blocks/0/ffn/experts_in"


@pytest.mark.parametrize("n", range(1, 18))
def test_host_mesh_shape_matches_reference(n, monkeypatch):
    """The reference's make_host_mesh arithmetic over n devices."""
    from repro.launch import mesh as jmesh
    got = {}
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda shape, axes: got.setdefault("s", shape))
    jmesh.make_host_mesh()
    assert host_mesh_shape(n) == tuple(got["s"])
    assert host_mesh_shape(n, 3, 5) == (3, 5)
