"""Nothing under ``portbench/`` imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is the port, ``repro`` the
JAX package), and the reference imports nothing of the program."""
import ast
import pathlib

import pytest

from portbench.tests.tiny import ROOT

FILES = sorted((ROOT / "portbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(_roots(path)) & FORBIDDEN


def test_names_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.db\nfrom repro.db import tpch\n")
    roots = set(_roots(probe))
    assert roots == {"repro_torch", "repro"}
    assert roots & FORBIDDEN == {"repro"}


@pytest.mark.parametrize(
    "path", sorted((ROOT / "portbench" / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_independent(path):
    roots = set(_roots(path))
    assert not roots & (FORBIDDEN | {"repro_torch", "portbench"}), roots
    text = path.read_text()
    assert "repro_torch" not in text.replace(
        "imports nothing of the program", "")
