"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Every source compiles with its own ``nvcc -c`` for ``sm_90a``, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in
``build/kernels/<hash>/`` at the root of the checkout; the hash covers the
sources and the flags, so an edited source rebuilds.  ``-Xptxas -v`` is on:
each kernel's registers, shared memory and spills go to ``build.log`` there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from ..core import config

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
#: C entry points and their argument types (pointers and the stream as
#: c_void_p, sizes as c_int, the Barrett magic as c_uint); every entry
#: returns cudaGetLastError().
SIGNATURES = {
    # p, a, a2, twiddles, partial_la, partial_an, la, an, n, num_freq,
    # shift, magic, smem_table, splits, freq_lo, freq_cnt, stream
    "logcf_launch": [P, P, P, P, P, P, P, P, I, I, I, U, I, I, I, I, P],
    # p, a, a2, bounds, piece_first, piece_start, piece_end, twiddles,
    # partial_la, partial_an, la, an, n_pieces, num_groups, num_freq,
    # shift, magic, short_max, freq_lo, freq_cnt, stream
    "group_logcf_launch": [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                           U, I, I, I, P],
    # p, v, gids, partial, out, n, tiles, num_groups, orders, stream
    "cumulant_sums_launch": [P, P, P, P, P, I, I, I, I, P],
    # p, v, g_sorted, bounds, partial, out, n, slots, num_groups, orders,
    # stream
    "group_cumulant_sums_launch": [P, P, P, P, P, P, I, I, I, I, P],
    # a, b, partial, c, na, nb, threads, slice, chunk, cluster, stream
    "polymul_launch": [P, P, P, P, I, I, I, I, I, I, P],
}

_LIB: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library if its sources changed; returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    deps = sources + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _source_hash(deps)
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [(s, subprocess.Popen(
        [nvcc, *FLAGS, "-c", str(s), "-o", str(tmp / (s.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for s in sources]
    log = []
    failed = []
    for s, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {s.name}\n{text}")
        if proc.returncode:
            failed.append(s.name)
    if not failed:
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp / lib.name),
             *(str(tmp / (s.stem + ".o")) for s in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    log.append(f"== build seconds {time.perf_counter() - t0:.3f}\n")
    (tmp / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(log))
    if out_dir.exists():           # built meanwhile by another process
        shutil.rmtree(tmp)
    else:
        tmp.rename(out_dir)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if "lib" not in _LIB:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB["lib"] = lib
    return _LIB["lib"]


def launch(name: str, *args) -> None:
    """Call one C entry point and raise on a CUDA error it reports."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


#: what the launches recorded inside ``core.config.dry_run()`` would have
#: cost: {kernel: {"launches", "flops", "bytes"}} (the bound formulas of
#: each wrapper's ``cost``); :func:`reset_fake_costs` clears it.
FAKE_COSTS: dict = {}


def reset_fake_costs() -> None:
    FAKE_COSTS.clear()


def faked(t, name: str, flops: int, nbytes: int) -> bool:
    """True when ``t`` is a ``FakeTensor`` inside the dry-run: the launch
    of kernel ``name`` is recorded with its FLOPs and bytes, not made.
    False for a real tensor; raises for a ``FakeTensor`` outside the
    dry-run (it holds no data to launch on)."""
    if not config.is_fake(t):
        return False
    if not config.in_dry_run():
        raise RuntimeError(f"{name}: a FakeTensor reached a kernel launch "
                           "outside the dry-run (core.config.dry_run)")
    rec = FAKE_COSTS.setdefault(name, dict(launches=0, flops=0, bytes=0))
    rec["launches"] += 1
    rec["flops"] += int(flops)
    rec["bytes"] += int(nbytes)
    return True


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_operand(name: str, t, dtype, n: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous 1-D CUDA tensor of ``dtype``
    (and length ``n``): what every C entry point takes."""
    if not config.on_card(t) or t.dtype != dtype or t.dim() != 1 \
            or not t.is_contiguous() or (n is not None and t.shape[0] != n):
        raise ValueError(
            f"{name}: expected a contiguous 1-D CUDA {dtype} tensor"
            + ("" if n is None else f" of length {n}")
            + f", got {t.dtype} {tuple(t.shape)} on {t.device}")
