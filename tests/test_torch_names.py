"""Public names: every public top-level function, class, class method and
constant of a reference module (``src/repro/<m>.py``) that has a
counterpart (``src/repro_torch/<m>.py``) exists there under its own
name, or is listed in ``ELSEWHERE`` with where the port has it, or in
``NONE`` with why it has none (ROADMAP.md, "Public names").  The JAX
pytree hooks (``tree_flatten`` / ``tree_unflatten``) have no meaning in
PyTorch and are not compared.  The names this check found missing and
the port then gained are held to the JAX package below."""
import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: reference module -> {name: "port file: name"} (moved or renamed)
ELSEWHERE = {
    "kernels/ops.py": {
        "logcf": "kernels/pb_cf.py: logcf",
        "group_logcf": "kernels/group_cf.py: group_logcf",
        "presort_group_operands": "kernels/group_cf.py: presort_operands",
        "cumulant_sums": "kernels/cumulants.py: cumulant_sums",
        "group_cumulant_sums":
            "kernels/group_cumulants.py: group_cumulant_sums",
        "presort_group_cumulant_operands":
            "kernels/group_cumulants.py: presort_operands",
        "polymul": "kernels/polymul.py: polymul",
    },
    "models/layers.py": {
        "apply_norm": "models/layers.py: Norm",
        "norm_params": "models/layers.py: Norm",
        "dense_init": "models/layers.py: dense_",
        "truncnorm": "models/layers.py: truncnorm_",
    },
    "models/mlp.py": {"mlp": "models/mlp.py: MLP",
                      "mlp_params": "models/mlp.py: MLP"},
    "models/moe.py": {"moe": "models/moe.py: MoE",
                      "moe_params": "models/moe.py: MoE"},
    "models/rglru.py": {"rglru": "models/rglru.py: RGLRU",
                        "rglru_params": "models/rglru.py: RGLRU"},
    "models/rwkv6.py": {"rwkv6_timemix": "models/rwkv6.py: RWKV6TimeMix",
                        "rwkv6_params": "models/rwkv6.py: RWKV6TimeMix"},
    "models/transformer.py": {
        "attention": "models/transformer.py: Attention",
        "attn_params": "models/transformer.py: Attention"},
}

#: reference module -> names with no counterpart, and why
NONE = {
    "db/plans.py": {
        "wave_cache_info": "the port compiles nothing: no jitted wave "
                           "cache to report on",
        "set_wave_cache_capacity": "the port compiles nothing: no jitted "
                                   "wave cache to bound",
    },
    "launch/dryrun.py": {
        "analyze": "reads XLA's cost analysis of a compiled program; the "
                   "port counts FLOPs and bytes while tracing",
        "parse_collective_bytes": "parses XLA's HLO text; the port's fake "
                                  "process group counts collectives",
        "COLLECTIVE_RE": "HLO text pattern",
        "DEF_RE": "HLO text pattern",
        "ICI_BW": "a TPU link rate; the port's roofline uses the H100's",
    },
}

PYTREE = {"tree_flatten", "tree_unflatten"}


def _names(path: pathlib.Path) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, ast.FunctionDef) \
                            and not m.name.startswith("_") \
                            and m.name not in PYTREE:
                        out.add(f"{node.name}.{m.name}")
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out.add(t.id)
    return out


PAIRS = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
               if (PORT / p.relative_to(REF)).exists())


@pytest.mark.parametrize("module", PAIRS)
def test_reference_names_have_a_counterpart(module):
    missing = _names(REF / module) - _names(PORT / module)
    moved = ELSEWHERE.get(module, {})
    none = NONE.get(module, {})
    unexplained = sorted(missing - moved.keys() - none.keys())
    assert not unexplained, f"{module}: {unexplained}"
    for name, where in moved.items():
        path, target = where.split(": ")
        assert target.split(".")[0] in _names(PORT / path), (name, where)
        assert name in missing, f"{module}: {name} is in the port now"
    assert set(none) <= missing, module


def test_every_reference_module_is_paired_or_listed():
    """A reference module with no port file is one of the two ROADMAP.md
    names: the JAX shims and ``models/runmode.py``."""
    unpaired = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                      if not (PORT / p.relative_to(REF)).exists())
    assert unpaired == ["compat.py", "models/runmode.py"]


# ----------------------------------- the names the check found, ported
def test_default_dtypes_follow_x64():
    from repro_torch.core import config
    saved = dict(config._X64)
    try:
        config._X64["on"] = False
        assert (config.default_complex(), config.default_int()) \
            == (torch.complex64, torch.int32)
        config._X64["on"] = True
        assert (config.default_complex(), config.default_int()) \
            == (torch.complex128, torch.int64)
    finally:
        config._X64.update(saved)


def test_atleastone_ref_matches_reference(rng):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    p = rng.uniform(0, 1, 300)
    g = rng.integers(0, 7, 300)
    got = ref.atleastone_ref(torch.from_numpy(p), torch.from_numpy(g), 9)
    want = jref.atleastone_ref(jnp.asarray(p), jnp.asarray(g), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)


def test_table_num_valid_and_to_pandas_like_match_reference(rng):
    import jax.numpy as jnp
    from repro.db.table import Table as JTable
    from repro_torch.db.table import Table
    cols = dict(a=rng.integers(0, 9, 40), b=rng.uniform(0, 1, 40))
    p = rng.uniform(0, 1, 40)
    valid = rng.uniform(0, 1, 40) < 0.6
    got = Table.from_numpy(cols, p, valid, device="cpu")
    want = JTable.from_columns({k: jnp.asarray(v) for k, v in cols.items()},
                               jnp.asarray(p), jnp.asarray(valid))
    assert int(got.num_valid()) == int(want.num_valid())
    g, w = got.to_pandas_like(), want.to_pandas_like()
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def test_chunk_accumulator_counts_filed_chunks():
    from repro_torch.core import uda
    u = {"c": uda.AtLeastOne()}
    acc = uda.ChunkStateAccumulator(u, 5)
    st = lambda: {"c": u["c"].init(1, torch.float64, "cpu")}
    assert acc.filed == 0
    acc.add_wave([2, 3], [st(), st()])       # pending, not yet folded
    assert acc.filed == 2
    acc.add_wave([0, 1, 7], [st(), st(), st()])   # 7: a padding slot
    assert acc.filed == 4
    acc.add_wave([4], [st()])
    assert acc.filed == 5
