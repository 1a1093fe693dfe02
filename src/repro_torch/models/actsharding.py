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
placements) into the tensor the layer computes on: an all-gather over the
DP axes in the forward pass; in the backward pass the gradient is summed
over the DP axes, divided by their size (the global batch's mean) and cut
back to the rank's chunk.

Tensor parallelism on 'model' (``models/tp.py``).  With a policy whose
``tp`` is set (a model axis of more than one rank), a leaf of a block
with a tensor-parallel form keeps its 'model' shard: the attention's
``wq``/``wk``/``wv`` (columns over the heads) and ``wo`` (rows), the dense
MLP's ``wi``/``wg`` (columns) and ``wo`` (rows), and the embedding and
unembedding tables (vocab rows).  ``models/tp.py`` decides which blocks
have that form and marks their dense dicts ``'tp'`` (``'col'``, ``'row'``
or ``'vocab'``), as the layers read them.  Every other leaf is gathered
whole, over 'model' too: MLA's, the RG-LRU's and Mamba-2's, the causal
conv, an attention block whose 'model' shard would cut a query head, a
factored or fake-quantized block (the policy then has no ``tp``).
``policy.counts`` counts the leaves gathered by mesh dim (``('gather',
dim)``, and ``('gather_tp', dim)`` for a leaf of a block with a
tensor-parallel form gathered whole) and, with their bytes (:func:`note`),
the collectives the model's tensor-parallel blocks (``models/tp.py``) and
its sequence-sharded decode (``attention._merge``) run, by axis, and the
train step's global-norm reductions (``('grad_norm', axis)``).

The MoE expert leaves (``moe``'s ``wi``, ``wg``, ``wo``) are the one
other exception: ``gather_params`` leaves them as :class:`LocalShard` for
``models/moe.py``, which knows its mode.  Its expert-parallel path takes
them through :func:`ep_weight` (gathered over the DP axes only; in a2a
mode the rank keeps its stored expert shard, in f-TP mode the leaf is
redistributed to its FFN dim cut over 'model', the layout of the
reference's ``shard_map`` in_specs), and its dense path through
:func:`gather_leaf`.  The ``'moe_buf'`` kind follows the reference's
rules for the dispatch buffer (experts over 'model' where they divide,
else the capacity over the mesh); like every kind it acts on DTensors
only.
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


def current_policy():
    """The installed policy (None on single device)."""
    return _POLICY


#: MoE leaves that ``gather_params`` leaves to ``models/moe.py``
EXPERT_LEAVES = ('wi', 'wg', 'wo')


def count(key, n=1):
    """``n`` more ``key`` in the installed policy's ``counts``, if any."""
    counts = getattr(_POLICY, 'counts', None)
    if counts is not None:
        counts[key] += n


def note(kind, x, axis, counts=None):
    """One more ``kind`` collective over the mesh axis ``axis`` with
    operand ``x``: ``(kind, axis)`` and ``(kind + '_bytes', axis)`` in
    ``counts``, by default the installed policy's (if any)."""
    if counts is None:
        counts = getattr(_POLICY, 'counts', None)
    if counts is not None:
        counts[(kind, axis)] += 1
        counts[(kind + '_bytes', axis)] += x.numel() * x.element_size()


def note_group(kind, x, group):
    """:func:`note` for a collective over the process group ``group``,
    named by the installed mesh's axis whose group it is."""
    mesh = _MESH
    if mesh is None:
        return
    for i, name in enumerate(mesh.mesh_dim_names):
        if mesh.get_group(i).group_name == group.group_name:
            note(kind, x, name)
            return


def gather_params(tree):
    """``tree`` with every :class:`LocalShard` leaf gathered by the
    installed policy's ``gather``: to its full tensor, or to its 'model'
    shard in a block with a tensor-parallel form (``models/tp.py``
    decides which, and marks their dense dicts ``'tp'``); the tree itself
    when no policy (or one without a gather) is installed.  The MoE
    expert leaves stay :class:`LocalShard` (module docstring)."""
    gather = getattr(_POLICY, 'gather', None)
    if gather is None:
        return tree
    from repro_torch.models import tp as tpm
    from repro_torch.tree import rebuild
    tp, cfg = getattr(_POLICY, 'tp', None), getattr(_POLICY, 'cfg', None)

    def leaf(x, keep, tp_leaf=False):
        if isinstance(x, LocalShard):
            for i, (n, p) in enumerate(zip(x.mesh.mesh_dim_names,
                                           x.placements)):
                if p.is_shard() and x.mesh.size(i) > 1 \
                        and not (keep and n == 'model'):
                    count(('gather', n))
                    if tp_leaf:
                        count(('gather_tp', n))
        return gather(x, keep_model=keep)

    def walk(node, key=None, tp_leaf=False):
        if isinstance(node, dict):
            if key == 'moe':
                return {k: v if k in EXPERT_LEAVES
                        and isinstance(v, LocalShard) else walk(v, k)
                        for k, v in node.items()}
            marks = tpm.block_marks(key, node, tp, cfg)
            if marks is not None:
                return {k: tpm.mark_dense(
                    {n: leaf(x, True, True) for n, x in d.items()},
                    marks[k], tp) for k, d in node.items()}
            if 'table' in node and tpm.table_mark(node['table'], tp):
                return {'table': leaf(node['table'], True, True),
                        'tp': 'vocab'}
            return {k: walk(v, k, tp_leaf or k == 'table' or (
                k in tpm.TP_BLOCKS.get(key, ()))) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return rebuild(node, (walk(v) for v in node))
        return leaf(node, False, tp_leaf)
    return walk(tree)


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


def _dp_mean(g, mesh):
    """A copy of ``g`` summed over the DP axes and divided by their
    size."""
    import torch.distributed as dist
    from repro_torch.kernels.ref import true_div
    g = g.contiguous().clone()
    dims = _dp_dims(mesh)
    for d in dims:
        if mesh.size(mesh.mesh_dim_names.index(d)) > 1:
            dist.all_reduce(g, group=mesh.get_group(d))
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in dims)
    return true_div(g, float(n)) if n > 1 else g


class _Redistribute(torch.autograd.Function):
    """Forward: a rank's chunk under ``src`` -> its chunk under ``dst``
    (``dst`` replicated over the DP axes; all of it replicated gathers the
    full leaf).  Backward: the gradient of the ``dst`` chunk summed over
    the DP axes, divided by their size (the global batch's mean), and
    redistributed back to this rank's ``src`` chunk."""

    @staticmethod
    def forward(ctx, local, mesh, src, dst):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.src, ctx.dst = mesh, src, dst
        out = DTensor.from_local(local, mesh, src, run_check=False) \
            .redistribute(mesh, dst).to_local()
        out = out.wait() if hasattr(out, 'wait') else out
        return out.clone() if out is local else out

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        g = _dp_mean(g, ctx.mesh)
        chunk = DTensor.from_local(g, ctx.mesh, ctx.dst, run_check=False) \
            .redistribute(ctx.mesh, ctx.src).to_local()
        chunk = chunk.wait() if hasattr(chunk, 'wait') else chunk
        return chunk.contiguous(), None, None, None


def ep_weight(x, mesh, dim: int):
    """An MoE expert leaf as the expert-parallel path takes it: replicated
    over the DP axes and cut over 'model' along ``dim`` (0, the expert
    axis, in a2a mode; the FFN dim in f-TP mode), differentiable.  ``x``
    is a :class:`LocalShard`, or a whole tensor (the same on every rank),
    which is cut here.  On a mesh of one rank the chunk is the leaf."""
    from torch.distributed.tensor import Replicate, Shard
    if not isinstance(x, LocalShard):
        x = LocalShard(x, mesh, (Replicate(),) * mesh.ndim)
    if mesh.size() == 1:
        return x.local
    dst = tuple(Shard(dim) if n == 'model' else Replicate()
                for n in mesh.mesh_dim_names)
    return _Redistribute.apply(x.local, mesh, x.placements, dst)


def gather_leaf(x, keep_model=False):
    """A :class:`LocalShard` as its full tensor (differentiable), or with
    ``keep_model`` as its 'model' shard (gathered over the DP axes only);
    any other leaf as it is.  On a mesh of one rank the chunk is the
    leaf."""
    from torch.distributed.tensor import Replicate
    if not isinstance(x, LocalShard):
        return x
    if x.mesh.size() == 1:
        return x.local
    dst = tuple(p if keep_model and n == 'model' else Replicate()
                for n, p in zip(x.mesh.mesh_dim_names, x.placements))
    return _Redistribute.apply(x.local, x.mesh, x.placements, dst)


def make_mesh_policy(mesh, *, batch_split=True, cfg=None):
    """Standard policy: batch dim over DP axes, the residual stream's
    features whole; vocab-sharded logits.  Plain tensors (a rank's local
    activations) pass as they are; a DTensor is redistributed to the
    kind's spec.  ``policy.gather`` is :func:`gather_leaf`.
    ``batch_split``: the step split its batch over every DP axis (the
    reference's ``B % dp == 0``, which the MoE block's expert-parallel
    path asks for).  ``policy.tp``: the 'model' axis (``models/tp.py``'s
    ``TPAxis``) when ``cfg`` is given, the axis has more than one rank
    and ``cfg`` fake-quantizes nothing (a fake-quant scale spans a row
    product's split rows); else None, and every leaf is gathered whole
    (setting it to None after the fact gives that gather path, which the
    tests hold the tensor-parallel one against).  ``policy.counts``
    counts gathers and collectives (module docstring)."""
    import collections
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.tp import TPAxis
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
        if kind == 'moe_buf':                        # (E, C, D) dispatch buf
            E, C = x.shape[0], x.shape[1]
            m = sizes['model']
            if E % m == 0 and C % n_dp == 0:
                return constrain(x, 'model', dps, None)
            if C % (n_dp * m) == 0:
                return constrain(x, None, dp + ('model',), None)
            if C % m == 0:
                return constrain(x, None, 'model', None)
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
    policy.batch_split = batch_split
    policy.cfg = cfg
    policy.counts = collections.Counter()
    policy.tp = None
    if cfg is not None and sizes['model'] > 1 \
            and not cfg.w_bits and not cfg.a_bits:
        m = list(sizes).index('model')
        policy.tp = TPAxis(sizes['model'], int(mesh.get_local_rank(m)),
                           mesh.get_group(m))
    return policy
