"""Package boundary of the port: no module under ``src/repro_torch/`` and
not ``chip_smoke.py`` imports JAX or the JAX package ``repro`` (checked
on the source's syntax tree, so an import inside a function counts too)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


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


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_whole_package():
    names = {p.name for p in FILES}
    assert {"uda.py", "plans.py", "physical.py", "tpch.py", "pb_cf.py",
            "group_cf.py", "pgf.py", "poisson_binomial.py", "polymul.py",
            "report.py", "faults.py", "chip_smoke.py", "distributed.py",
            "mesh.py", "ranks.py", "serving.py", "serve.py"} <= names
