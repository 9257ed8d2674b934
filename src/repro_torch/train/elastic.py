"""Elastic scaling: restore / reshard state across different meshes (the
port of ``repro.train.elastic``).

A checkpoint written under mesh A (say 2 x 16 x 16) must restore onto
mesh B (16 x 16, or a degraded 15-host pod) -- that is what makes node
failures survivable without identical spare capacity.  Because
checkpoints store full logical arrays per key, resharding is a pure
placement decision:

    reshard(tree, rules_B)   ->   every leaf re-placed with mesh B's specs

:func:`degrade_mesh` builds the largest (data, model) mesh from a
reduced rank count -- the pod-loses-hosts path; :func:`scale_batch`
recomputes the per-shard batch so the global batch is preserved under the
new data-axis size (synchronous elastic semantics: the optimizer
trajectory is unchanged because the *global* batch, not the per-rank
batch, is the contract).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh
from ..sharding import NamedSharding, Rules, Sharded


def _reshard_leaf(leaf: Sharded, rules: Rules) -> Sharded:
    """One leaf under ``rules``, its spec derived from the same rule (a
    parameter's reference path and shape; none: replicated)."""
    old, mesh = leaf.sharding.mesh, rules.mesh
    new = NamedSharding(mesh, rules.spec_for(leaf.sharding.rule,
                                             len(leaf.shape)),
                        leaf.sharding.rule)
    full = leaf.full(kind="reshard")
    if not set(mesh.ranks) <= set(old.ranks):
        # a rank joins: the first rank of the old mesh sends it the array
        if full is None:
            full = torch.empty(leaf.shape, dtype=leaf.dtype,
                               device=mesh.device)
        dist.broadcast(full, src=old.ranks[0])
    local = new.local(full) if new.member else None
    if local is not None:
        local = local.to(mesh.device)
    return Sharded(local, new, leaf.shape, leaf.dtype)


def reshard(tree, rules: Rules):
    """Re-place every :class:`~repro_torch.sharding.Sharded` leaf of a
    nested dict with the rules of a (new) mesh: bit for bit the same
    logical tensors.  Every process of the group calls it (the old mesh's
    ranks gather each leaf; a rank new to the mesh receives it from the
    old mesh's first rank)."""
    if isinstance(tree, dict):
        return {k: reshard(v, rules) for k, v in tree.items()}
    return _reshard_leaf(tree, rules)


def degrade_shape(n: int, prefer_model: int = 16) -> tuple:
    """(data, model) of :func:`degrade_mesh` over ``n`` ranks: the model
    axis doubles while it stays <= ``prefer_model`` and <= n, data is
    n // model."""
    model = 1
    while model * 2 <= prefer_model and n // (model * 2) >= 1 \
            and (model * 2) <= n:
        model *= 2
    return n // model, model


def degrade_mesh(ranks: Sequence[int], prefer_model: int = 16, *,
                 backend: str | None = None, device="cuda") -> Mesh:
    """Largest (data, model) mesh from an arbitrary rank count.

    Keeps the model axis at the largest power of two <= prefer_model (and
    <= the count) so TP groups stay intact; leftover ranks are left out
    of the mesh (they rejoin at the next resize) -- the simple,
    deterministic policy a 1000-node fleet can agree on without
    coordination.  Every process of the group builds it."""
    data, model = degrade_shape(len(ranks), prefer_model)
    return Mesh((data, model), ("data", "model"), backend=backend,
                device=device, ranks=list(ranks)[:data * model])


def scale_batch(global_batch: int, mesh) -> int:
    """Per-data-shard batch preserving the global batch (synchronous
    elasticity).  Requires divisibility; callers pad the batch up."""
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    if global_batch % dp:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {dp} data shards")
    return global_batch // dp
