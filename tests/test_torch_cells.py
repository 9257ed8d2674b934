"""The port's cells (``repro_torch.launch.cells``) against the JAX
package's (``repro.launch.cells``): the same 32 (arch, shape) cells, the
same memory knobs, and every cell's ``in_shardings`` spec equal leaf for
leaf on both production meshes, (16, 16) and (2, 16, 16): parameters
(through ``models/convert.py``'s leaf mapping: the reference leaf's spec
without the stacked period dim, reversed for a transposed ``nn.Linear``
weight), optimizer state, batch and decode cache.

The JAX side runs once, in a subprocess with 512 CPU devices (only
shapes: ``build_cell`` evaluates parameter shapes, nothing is lowered),
and prints its specs as JSON.  The port's cells are built on a mesh
stand-in (axis names, sizes, rank 0's coordinates): building a cell
touches no process group.
"""
import json

import pytest

from repro_torch.configs import base as cfgs
from repro_torch.launch import cells as C

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

JAX_SCRIPT = r'''
import json
import jax
from repro.launch import cells as C
from repro.configs import base as cfgs
from repro.launch.mesh import make_production_mesh


def norm(spec):
    out = []
    for e in spec:
        if isinstance(e, tuple):
            e = list(e) if len(e) != 1 else e[0]
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return out


def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)


out = {"cells": C.all_cells(), "knobs": {}, "specs": {}}
for arch in cfgs.ARCH_IDS:
    kn = C.arch_knobs(cfgs.get_config(arch))
    kn["accum_dtype"] = jax.numpy.dtype(kn["accum_dtype"]).name
    out["knobs"][arch] = kn
for mp, tag in ((False, "16x16"), (True, "2x16x16")):
    mesh = make_production_mesh(multi_pod=mp)
    for arch, shape in C.all_cells():
        cell = C.build_cell(arch, shape, mesh)
        flat = {}
        for path, sh in jax.tree_util.tree_leaves_with_path(
                cell.in_shardings,
                is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)):
            flat["/".join(key(k) for k in path)] = norm(sh.spec)
        out["specs"][f"{tag}|{arch}/{shape}"] = flat
print(json.dumps(out))
'''


class _Mesh:
    """What building a cell reads of a mesh: axis names, sizes, rank 0's
    coordinates; no process group."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.coords = {a: 0 for a in names}

    def axis(self, names):
        return None


def _norm(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return [list(e) if isinstance(e, tuple) else e for e in out]


@pytest.fixture(scope="module")
def ref():
    from conftest import run_sub
    return json.loads(run_sub(JAX_SCRIPT, devices=512).strip()
                      .splitlines()[-1])


def _port_specs(arch, shape, mesh) -> dict:
    """{reference leaf path: spec} of the port's cell, parameters mapped
    back to the reference's leaves (stacked dim restored as None,
    transposed leaves reversed), checking that every port parameter of a
    stacked leaf agrees."""
    cell = C.build_cell(arch, shape, mesh)
    out = {}

    def ref_param(prefix, sh):
        path, _, stacked, transposed = sh.rule
        spec = list(sh.spec)
        spec = spec[::-1] if transposed else spec
        spec = ([None] if stacked else []) + spec
        key = f"{prefix}/{path}"
        if key in out:
            assert out[key] == _norm(spec), key
        out[key] = _norm(spec)

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
            return
        out["/".join(path)] = _norm(node.spec)

    for k, v in cell.in_shardings.items():
        if k == "params":
            for sh in v.values():
                ref_param("params", sh)
        elif k == "opt_state":
            out["opt_state/step"] = _norm(v["step"].spec)
            for m in ("mu", "nu"):
                for sh in v[m].values():
                    ref_param(f"opt_state/{m}", sh)
        else:
            visit(v, (k,))
    return out


def test_all_cells_match(ref):
    got = C.all_cells()
    assert [list(c) for c in got] == ref["cells"]
    assert len(got) == 32


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_arch_knobs_match(ref, arch):
    kn = dict(C.arch_knobs(cfgs.get_config(arch)))
    kn["accum_dtype"] = str(kn["accum_dtype"]).replace("torch.", "")
    assert kn == ref["knobs"][arch]


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", C.all_cells())
def test_in_shardings_match(ref, arch, shape, tag):
    mesh = _Mesh(*MESHES[tag])
    want = ref["specs"][f"{tag}|{arch}/{shape}"]
    got = _port_specs(arch, shape, mesh)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:8]
