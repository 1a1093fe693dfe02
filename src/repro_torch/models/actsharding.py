"""Activation-sharding policy hook (the reference's
``models/actsharding.py``), and the per-layer parameter gather that the
port's sharded steps run through it.

Model code calls ``shard_act(x, kind)`` at layer boundaries; by default it
is the identity (single device, the CPU tests).  The reference's launcher
installs a policy that applies ``with_sharding_constraint`` (batch over
the DP axes on the residual stream), which anchors GSPMD's propagation so
FSDP'd weights are all-gathered per layer instead of activations being
replicated.

The port has no GSPMD: its sharded steps (``launch/steps.py``) run one
program per rank on that rank's chunk of the batch, so an activation is
already a rank's local tensor, batch-sharded by construction.  The mesh
policy therefore leaves plain tensors as they are and redistributes only
a DTensor to the kind's spec.  What GSPMD inserted by itself, the port
does by hand through the same hook: :func:`gather_params`, which the
model calls on each layer's param tree just before the layer runs (and on
the embedding, the final norm and the unembedding), is the identity
unless the installed policy has a ``gather``.  The mesh policy's gather
turns each :class:`LocalShard` (a rank's chunk of a leaf, with its
placements) into the full leaf: an all-gather in the forward pass; in the
backward pass the gradient is summed over the DP axes, divided by their
size (the global batch's mean) and cut back to the rank's chunk.  The
``'moe_buf'`` kind is left as it is: the expert-parallel dispatch comes
with the MoE mesh path (ROADMAP queue A item 10.3).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch

_POLICY: Callable | None = None
_MESH = None


def set_policy(fn: Callable | None, mesh=None):
    global _POLICY, _MESH
    _POLICY = fn
    _MESH = mesh


@contextlib.contextmanager
def activation_sharding(fn: Callable, mesh=None):
    global _POLICY, _MESH
    prev, prev_mesh = _POLICY, _MESH
    _POLICY, _MESH = fn, mesh if mesh is not None else getattr(
        fn, 'mesh', None)
    try:
        yield
    finally:
        _POLICY, _MESH = prev, prev_mesh


def shard_act(x, kind: str = 'residual'):
    if _POLICY is None:
        return x
    return _POLICY(x, kind)


def current_mesh():
    """Mesh installed with the active policy (None on single device)."""
    return _MESH


def gather_params(tree):
    """``tree`` with every :class:`LocalShard` leaf gathered to its full
    tensor by the installed policy's ``gather``; the tree itself when no
    policy (or one without a gather) is installed."""
    gather = getattr(_POLICY, 'gather', None)
    if gather is None:
        return tree
    from repro_torch.tree import tree_map
    return tree_map(gather, tree)


# ------------------------------------------------------- sharded parameters


class LocalShard:
    """A rank's chunk of one parameter leaf and the leaf's placements on
    ``mesh``.  Indexing takes one layer of a stacked ``(G, ...)`` leaf,
    whose group dim the sharding rules never shard."""
    __slots__ = ('local', 'mesh', 'placements')

    def __init__(self, local, mesh, placements):
        self.local, self.mesh, self.placements = local, mesh, tuple(placements)

    def __getitem__(self, g):
        from torch.distributed.tensor import Shard
        if any(isinstance(p, Shard) and p.dim == 0 for p in self.placements):
            raise ValueError('the stacked dim of a leaf is sharded')
        return LocalShard(self.local[g], self.mesh, tuple(
            Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in self.placements))


def _dp_dims(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a != 'model')


class _Gather(torch.autograd.Function):
    """Forward: a rank's chunk -> the full leaf (all-gather).  Backward:
    the full leaf's gradient -> summed over the DP axes, divided by their
    size, this rank's chunk of it."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        from torch.distributed.tensor import DTensor, Shard
        ctx.mesh, ctx.placements = mesh, placements
        if not any(isinstance(p, Shard) for p in placements):
            return local.clone()
        full = DTensor.from_local(local, mesh, placements,
                                  run_check=False).full_tensor()
        return full.wait() if hasattr(full, 'wait') else full

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.kernels.ref import true_div
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dims = _dp_dims(mesh)
        for d in dims:
            dist.all_reduce(g, group=mesh.get_group(d))
        n = math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in dims)
        if n > 1:
            g = true_div(g, float(n))
        chunk = DTensor.from_local(
            g, mesh, [Replicate()] * mesh.ndim, run_check=False
        ).redistribute(mesh, ctx.placements).to_local()
        chunk = chunk.wait() if hasattr(chunk, 'wait') else chunk
        return chunk.contiguous(), None, None


def gather_leaf(x):
    """A :class:`LocalShard` as its full tensor (differentiable), any other
    leaf as it is.  On a mesh of one rank the chunk is the leaf."""
    if not isinstance(x, LocalShard):
        return x
    if x.mesh.size() == 1:
        return x.local
    return _Gather.apply(x.local, x.mesh, x.placements)


def make_mesh_policy(mesh):
    """Standard policy: batch dim over DP axes, features unsharded (TP on
    features emerges from the weight shardings); vocab-sharded logits.
    Plain tensors (a rank's local activations) pass as they are; a
    DTensor is redistributed to the kind's spec.  ``policy.gather`` is
    :func:`gather_leaf`."""
    from repro_torch.launch.mesh import mesh_axes
    sizes = mesh_axes(mesh)
    dp = tuple(a for a in sizes if a != 'model')
    dps = dp if len(dp) > 1 else dp[0]
    n_dp = math.prod(sizes[a] for a in dp)

    def constrain(x, *spec):
        from torch.distributed.tensor import DTensor
        from repro_torch.launch.sharding import P, placements
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, placements(P(*spec), mesh))

    def policy(x, kind):
        if kind == 'residual':                       # (B, S, D)
            if x.ndim == 3 and x.shape[0] % n_dp == 0:
                return constrain(x, dps, None, None)
            return x
        if kind == 'residual1':                      # (B, D) decode
            if x.shape[0] % n_dp == 0:
                return constrain(x, dps, None)
            return x
        if kind == 'logits':                         # (..., vocab)
            spec = (dps,) + (None,) * (x.ndim - 2) + ('model',)
            if x.shape[0] % n_dp == 0 \
                    and x.shape[-1] % sizes['model'] == 0:
                return constrain(x, *spec)
            return x
        return x

    policy.mesh = mesh
    policy.gather = gather_leaf
    return policy
