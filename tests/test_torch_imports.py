"""Package boundary of the port: no module under ``src/repro_torch/``,
not ``chip_smoke.py`` and no torch twin of an example
(``examples/*_torch.py``) imports JAX or the JAX package ``repro``
(checked on the source's syntax tree, so an import inside a function
counts too, and so does ``importlib.import_module`` of a string or
f-string that names a ``repro.`` module).  The twins import only
``repro_torch``, ``torch``, ``numpy`` and the standard library."""
import ast
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLE_ROOTS = {"repro_torch", "torch", "numpy"} \
    | set(sys.stdlib_module_names)


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]
        elif isinstance(node, ast.Call) and _is_import_module(node.func) \
                and node.args:
            head = _literal_head(node.args[0])
            if head is not None:
                yield head.split(".")[0]


def _is_import_module(func) -> bool:
    """``importlib.import_module`` or a bare ``import_module``."""
    return getattr(func, "attr", getattr(func, "id", None)) \
        == "import_module"


def _literal_head(arg):
    """The constant text an import-path argument starts with: a string,
    or an f-string's leading literal part; None otherwise."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values \
            and isinstance(arg.values[0], ast.Constant):
        return arg.values[0].value
    return None


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_example_twins_import_only_the_port_torch_numpy(path):
    bad = sorted(set(_imported_roots(path)) - EXAMPLE_ROOTS)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_example_twins():
    assert {p.name for p in EXAMPLES} == {
        "quickstart_torch.py", "tpch_probabilistic_torch.py",
        "out_of_core_query_torch.py", "distributed_query_torch.py",
        "train_lm_torch.py"}


def test_guard_sees_the_whole_package():
    names = {p.name for p in FILES}
    assert {"uda.py", "plans.py", "physical.py", "tpch.py", "pb_cf.py",
            "group_cf.py", "pgf.py", "poisson_binomial.py", "polymul.py",
            "report.py", "faults.py", "chip_smoke.py", "distributed.py",
            "mesh.py", "ranks.py", "serving.py", "serve.py", "api.py",
            "transformer.py", "moe.py", "rglru.py", "rwkv6.py",
            "base.py", "sharding.py", "elastic.py", "checkpoint.py",
            "trainer.py", "sweep.py"} <= names


@pytest.mark.parametrize("source,bad", [
    ("importlib.import_module('repro.configs.yi_6b')", True),
    ("importlib.import_module(f\"repro.configs.{name}\")", True),
    ("from importlib import import_module\nimport_module('jax.numpy')",
     True),
    ("importlib.import_module(f\"{__package__}.{name}\")", False),
    ("importlib.import_module('repro_torch.configs')", False),
])
def test_guard_sees_string_imports(tmp_path, source, bad):
    f = tmp_path / "m.py"
    f.write_text("import importlib\n" + source + "\n")
    found = set(_imported_roots(f)) & set(FORBIDDEN)
    assert bool(found) == bad, found
