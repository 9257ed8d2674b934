"""Manifest-ed, atomically committed, verified checkpoints (the port of
``repro.train.checkpoint``, same layout and contract):

    <dir>/step_000123/
        manifest.json      step, key list, shapes, dtypes, process count,
                           per-file SHA-256 content hashes, extra
        shard_00000.npz    this process's tensors

* write to ``step_X.tmp-<nonce>/``, then ``os.replace`` -> ``step_X/``
  (atomic on POSIX): a crash mid-save never corrupts the latest
  checkpoint;
* every file carries a content hash, verified on restore;
* :func:`latest_step` scans for the newest COMMITTED checkpoint (tmp dirs
  are ignored), so restart-after-failure is ``restore(dir,
  latest_step(dir), like)``;
* a tree is a nested dict of tensors; its keys are the ``/``-joined paths.

Under a mesh (leaves that are ``sharding.Sharded``: a rank's block of a
logical tensor), :func:`save` writes **full logical arrays**, as the
reference does: every rank of the group calls it, the ranks gather each
leaf, and one process per host writes ``shard_<rank>.npz`` (the ranks
must share the checkpoint directory's file system); rank 0 writes the
manifest with every file's hash and commits.  ``restore(shardings=)``
places each leaf with the target mesh's :class:`~repro_torch.sharding.
NamedSharding` (``sharding.state_shardings(rules, cfg)``), whatever mesh
wrote it (``train/elastic.py``).

One deliberate difference: a bfloat16 tensor is stored as its raw 16
bits (a ``uint16`` array) with ``"bfloat16"`` in ``dtypes``, and restored
bit-exact.  The reference saves ``ml_dtypes`` bfloat16 through
``np.savez`` as an opaque ``V2`` array that its own restore cannot cast
back.  Float32 and integer checkpoints read both ways between the
packages.
"""
from __future__ import annotations

import hashlib
import json
import os
import secrets
import shutil
import socket
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..sharding import Sharded


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": tensor} of a nested dict of tensors, in the dict's
    order."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _unflatten_like(like, flat: dict, prefix: str = ""):
    return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
            if isinstance(v, dict) else flat[f"{prefix}{k}"]
            for k, v in like.items()}


def _to_numpy(t) -> tuple:
    """(array to store, dtype name for the manifest)."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _process() -> tuple:
    """(this process's index, process count)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _manifest(step, flat, pcount, hashes, extra) -> dict:
    return {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: d for k, (_, d) in flat.items()},
        "process_count": pcount,
        "hashes": hashes,
        "extra": extra or {},
    }


def _commit(tmp: str, final: str, manifest: dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                           # atomic commit


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None):
    """Atomically save ``tree`` (a nested dict of tensors, or of
    ``sharding.Sharded`` leaves: then every rank calls it, see the module
    docstring).  Returns the committed directory."""
    flat_tree = flatten(tree)
    if any(isinstance(v, Sharded) for v in flat_tree.values()):
        return _save_sharded(ckpt_dir, step, flat_tree, extra)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp-" + secrets.token_hex(4)
    os.makedirs(tmp)
    try:
        flat = {k: _to_numpy(v) for k, v in flat_tree.items()}
        pidx, pcount = _process()
        shard_file = os.path.join(tmp, f"shard_{pidx:05d}.npz")
        np.savez(shard_file, **{k: a for k, (a, _) in flat.items()})
        _commit(tmp, final, _manifest(
            step, flat, pcount,
            {os.path.basename(shard_file): _sha256(shard_file)}, extra))
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _save_sharded(ckpt_dir: str, step: int, flat_tree: dict, extra):
    """:func:`save` of a tree with ``Sharded`` leaves, on every rank."""
    rank, world = _process()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    writer = names.index(names[rank]) == rank      # first rank on its host
    nonce = [secrets.token_hex(4) if rank == 0 else None]
    dist.broadcast_object_list(nonce, src=0)
    tmp = final + ".tmp-" + nonce[0]
    if rank == 0:
        os.makedirs(tmp)
    dist.barrier()
    flat, hashes = {}, {}
    try:
        for k, v in flat_tree.items():
            full = v.full(kind="checkpoint") if isinstance(v, Sharded) else v
            if writer:
                flat[k] = _to_numpy(full)
        if writer:
            shard_file = os.path.join(tmp, f"shard_{rank:05d}.npz")
            np.savez(shard_file, **{k: a for k, (a, _) in flat.items()})
            hashes[os.path.basename(shard_file)] = _sha256(shard_file)
        every = [None] * world
        dist.all_gather_object(every, hashes)
        if rank == 0:
            _commit(tmp, final, _manifest(
                step, flat, world, {f: h for d in every for f, h in d.items()},
                extra))
    except BaseException:
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp" not in name \
                and os.path.isfile(os.path.join(ckpt_dir, name,
                                                "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any = None):
    """Restore into the structure of ``like`` (a nested dict of tensors):
    each leaf in ``like``'s dtype and on its device.  ``shardings``: an
    optional matching tree of ``NamedSharding`` (elastic restore): a leaf
    it names comes back as a ``Sharded`` leaf, this rank's block on the
    mesh's device in ``like``'s dtype (``like``'s leaf may then be a
    ``Sharded`` one).  Returns (tree, manifest)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for fname, want in manifest["hashes"].items():
        got = _sha256(os.path.join(d, fname))
        if got != want:
            raise IOError(f"checkpoint corruption: {fname} hash mismatch")
    data = {}
    for name in os.listdir(d):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                data.update({k: z[k] for k in z.files})

    flat_like = flatten(like)
    missing = set(flat_like) - set(data)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    flat_sh = flatten(shardings) if shardings is not None else {}
    out = {}
    for key, leaf in flat_like.items():
        t = _from_numpy(data[key], manifest["dtypes"].get(key, ""))
        dtype = leaf.dtype
        if key in flat_sh:
            sh = flat_sh[key]
            local = sh.local(t)
            if local is not None:
                local = local.to(device=sh.mesh.device, dtype=dtype)
            out[key] = Sharded(local, sh, t.shape, dtype)
        else:
            out[key] = t.to(device=leaf.device, dtype=dtype)
    return _unflatten_like(like, out), manifest
