"""Tensor parallelism on the 'model' axis: Megatron's column and row
products, the vocab-parallel embedding, logits and cross-entropy.

The mesh policy's gather (``models/actsharding.py``) keeps a leaf that
the sharding rules put on 'model' as this rank's 'model' shard (gathered
over the DP axes only) where the block has a tensor-parallel form, and
this module marks its dense dict with ``'tp'``: ``'col'`` (the weight's output columns are
split), ``'row'`` (its input rows are split) or ``'vocab'`` (an embedding
table's rows).  The layers then compute on the shard:

* a column product takes its input through :func:`copy_in` (forward the
  identity; backward the input's gradient summed over 'model': each rank's
  columns give a part of it);
* a row product's output is this rank's part of the sum, which
  :func:`reduce_out` all-reduces over 'model' (backward the identity);
* :func:`gather_cols` all-gathers a column-split activation (the k/v of a
  layer whose 'model' shard cuts a kv head, the decode's q/k/v); its
  backward sums the gradient over 'model' and keeps this rank's chunk.

So the residual stream is whole on every rank of a 'model' group and its
gradient too, as in the single-device step; each leaf's gradient is this
rank's shard's.  :class:`TPAxis` names the axis: its size, this rank's
index on it and the process group.  A ``TPAxis`` with no group plays one
rank of the axis in one process (no collective may run): the rank-local
layer functions (``attention.gqa_partial``, ``layers.mlp_partial``,
:func:`vocab_ce_parts`) then give that rank's part before the all-reduce,
which a caller sums over the ranks itself.

This module also decides which blocks compute on their shards
(:func:`block_marks`, :func:`table_mark`): the mesh policy's gather only
calls it, and the step builders read :func:`logits_tp` to know that the
logits are a vocab chunk.  Every collective here counts itself in the
installed policy's ``counts``: ``(kind, 'model')`` calls and
``(kind + '_bytes', 'model')`` operand bytes, as the reference's
``hlo_analysis`` counts a compiled step's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TPAxis:
    """The 'model' axis as a rank sees it: ``size`` ranks, this one at
    ``rank``; ``group`` its process group (None: one process playing this
    rank, no collective)."""
    size: int
    rank: int
    group: object = None


def current_tp():
    """The installed policy's :class:`TPAxis` (None without tensor
    parallelism)."""
    from repro_torch.models.actsharding import current_policy
    return getattr(current_policy(), 'tp', None)


def _note(kind, x):
    """One more ``kind`` collective over 'model' with operand ``x``."""
    from repro_torch.models.actsharding import note
    note(kind, x, 'model')


def _needs_group(tp, what):
    if tp.group is None:
        raise ValueError(f'{what} over a model axis of {tp.size} needs its '
                         f'process group (a TPAxis without one plays one '
                         f'rank and runs no collective)')


def _all_reduce(x, group, op=None):
    import torch.distributed as dist
    x = x.contiguous().clone()
    _note('all_reduce', x)
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


def _all_gather(x, group, size):
    """The ``size`` ranks' ``x`` of the group, in rank order."""
    import torch.distributed as dist
    x = x.contiguous()
    _note('all_gather', x)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return parts


class _CopyIn(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Forward: the sum over the group.  Backward: the identity (the sum
    is whole on every rank and so is its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    """Forward: the last dim all-gathered over the group in rank order.
    Backward: the gradient summed over the group, this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[-1]
        return torch.cat(_all_gather(x, group, size), dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        lo = ctx.rank * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None, None, None


def copy_in(x, tp):
    """``x`` entering column products on this rank's shard."""
    if tp.size == 1 or tp.group is None:
        return x
    return _CopyIn.apply(x, tp.group)


def reduce_out(x, tp):
    """The sum over 'model' of the row products' parts."""
    if tp.size == 1:
        return x
    _needs_group(tp, 'the sum')
    return _ReduceOut.apply(x, tp.group)


def gather_cols(x, tp):
    """The last dim of ``x`` (this rank's columns) all-gathered over
    'model'."""
    if tp.size == 1:
        return x
    _needs_group(tp, 'the gather')
    return _GatherCols.apply(x, tp.group, tp.rank, tp.size)


def rank_cols(x, tp):
    """This rank's chunk of the last dim of ``x``, a tensor whole on every
    rank (its gradient then comes from every rank's chunk: summed over
    'model')."""
    n = x.shape[-1] // tp.size
    return copy_in(x, tp)[..., tp.rank * n:(tp.rank + 1) * n]


# ----------------------------------------------------------------- vocab


def vocab_embed(table, tokens, dtype, tp):
    """This rank's part of the embedding of ``tokens``: the rows of its
    vocab range ``table`` (``Vl`` rows from ``rank * Vl``), zeros for a
    token outside it.  The sum over 'model' is the embedding, exactly
    (one part is nonzero)."""
    n = table.shape[0]
    lo = tp.rank * n
    inside = (tokens >= lo) & (tokens < lo + n)
    idx = torch.where(inside, tokens - lo, torch.zeros_like(tokens))
    rows = table[idx].to(dtype)
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def vocab_ce_parts(logits, labels, lo, m):
    """This vocab chunk's part of the cross-entropy, given the max ``m``
    over the whole vocab (per token): the sum of ``exp(logit - m)`` over
    the chunk and the label's logit where the label lies in the chunk
    (which starts at ``lo``), else 0."""
    n = logits.shape[-1]
    s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    inside = (labels >= lo) & (labels < lo + n)
    idx = torch.where(inside, labels - lo, torch.zeros_like(labels))
    t = torch.gather(logits, -1, idx[..., None].to(torch.int64))[..., 0]
    return s, torch.where(inside, t, torch.zeros_like(t))


def ce_from_parts(s, t, m):
    """The mean cross-entropy from the sums over the vocab chunks."""
    return torch.mean(torch.log(s) + m - t)


def vocab_parallel_ce(logits, labels, tp):
    """The mean cross-entropy of vocab-sharded ``logits`` (this rank's
    chunk of the vocab, in fp32 here): the max, the sum of exponentials
    and the label's logit each all-reduced over 'model'; no rank holds
    the whole vocab."""
    import torch.distributed as dist
    _needs_group(tp, 'the cross-entropy')
    logits = logits.to(torch.float32)
    with torch.no_grad():
        m = _all_reduce(torch.amax(logits, dim=-1), tp.group,
                        dist.ReduceOp.MAX)
    s, t = vocab_ce_parts(logits, labels, tp.rank * logits.shape[-1], m)
    return ce_from_parts(reduce_out(s, tp), reduce_out(t, tp), m)


def vocab_argmax(logits, tp):
    """The greedy token of vocab-sharded ``logits`` (this rank's chunk):
    each rank's max and the first index of it, all-gathered over 'model';
    the first rank holding the overall max gives the token, which is
    ``torch.argmax`` over the whole vocab.  No rank holds the whole
    vocab."""
    _needs_group(tp, 'the argmax')
    best = torch.amax(logits, dim=-1).to(torch.float32)
    idx = torch.argmax(logits, dim=-1) + tp.rank * logits.shape[-1]
    vals = torch.stack(_all_gather(best, tp.group, tp.size))
    idxs = torch.stack(_all_gather(idx, tp.group, tp.size))
    return torch.gather(idxs, 0, torch.argmax(vals, dim=0)[None])[0]


# ------------------------------------------------------------- the forms

#: the dense dicts of a block with a tensor-parallel form, by the block's
#: key in a layer's param tree (an MLP's ``wg`` only where it is gated)
TP_BLOCKS = {'attn': ('wq', 'wk', 'wv', 'wo'),
             'xattn': ('wq', 'wk', 'wv', 'wo'),
             'mlp': ('wi', 'wg', 'wo')}
_DENSE_KEYS = {'w', 'b', 'w_q', 'scale'}


def _weight(d):
    return d['w'] if 'w' in d else d['w_q']


def model_dim(x):
    """The dim of the param leaf ``x`` (a ``LocalShard``) that 'model'
    cuts; None where it does not, or for any other leaf."""
    from torch.distributed.tensor import Shard
    from repro_torch.models.actsharding import LocalShard
    if not isinstance(x, LocalShard):
        return None
    p = x.placements[list(x.mesh.mesh_dim_names).index('model')]
    return p.dim if isinstance(p, Shard) else None


def _dense_mark(d):
    """'col', 'row' or None for a dense dict: where 'model' cuts its
    weight."""
    w = _weight(d)
    dim = model_dim(w)
    if dim is None:
        return None
    return 'col' if dim == w.local.dim() - 1 else 'row'


def block_marks(key, node, tp, cfg):
    """``{name: 'col' | 'row' | None}`` for the dense dicts of the block
    ``node`` under ``key`` where it computes on its 'model' shards, else
    None (every leaf then gathered whole): a GQA attention or a dense MLP
    of plain dense dicts (no factored form) whose ``wo`` 'model' cuts by
    rows, with an attention's query heads whole on each rank."""
    names = TP_BLOCKS.get(key)
    if tp is None or names is None \
            or set(node) - {'wg'} != set(names) - {'wg'} \
            or not all(isinstance(d, dict) and ('w' in d or 'w_q' in d)
                       and set(d) <= _DENSE_KEYS for d in node.values()):
        return None
    marks = {n: _dense_mark(d) for n, d in node.items()}
    if marks['wo'] != 'row':
        return None
    if key != 'mlp' and marks['wq'] == 'col' and cfg.num_heads % tp.size:
        return None                       # 'model' would cut a query head
    return marks


def table_mark(table, tp):
    """'vocab' where the embedding or unembedding ``table`` computes on its
    'model' shard (its vocab rows), else None."""
    return 'vocab' if tp is not None and model_dim(table) == 0 else None


def logits_tp(params, tp):
    """``tp`` where the model's logits come out as this rank's vocab chunk
    (its unembedding table marked ``'vocab'``), else None."""
    head = params.get('unembed', params['embed'])
    return tp if table_mark(head['table'], tp) else None


def mark_dense(d, mark, tp):
    """A gathered dense dict of a tensor-parallel block, marked
    ``'tp'``; with ``'col'``, a bias or an int8 scale the rules left whole
    (a (1, f) scale does not divide) cut to this rank's columns."""
    if mark is None:
        return d
    out = {**d, 'tp': mark}
    if mark == 'col':
        n = _weight(out).shape[-1]
        for k in ('b', 'scale'):
            if k in out and out[k].shape[-1] == n * tp.size:
                out[k] = rank_cols(out[k], tp)
    return out


def rank_shard(d, mark, rank, size):
    """A whole dense dict cut to one rank's 'model' shard as the sharding
    rules cut it and marked as the mesh policy marks it: ``'col'`` the
    weight's and the bias' last dim, ``'row'`` the weight's first (its
    bias whole), ``'vocab'`` a table's rows."""
    def cut(t, dim):
        n = t.shape[dim] // size
        return t.narrow(dim, rank * n, n)
    if mark == 'vocab':
        return {'table': cut(d['table'], 0), 'tp': mark}
    if mark == 'col':
        return {**{k: cut(v, -1) for k, v in d.items()}, 'tp': mark}
    return {**d, 'w': cut(d['w'], 0), 'tp': mark}
