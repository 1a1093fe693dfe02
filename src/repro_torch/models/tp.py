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
(:func:`block_marks`, :func:`table_mark`, :func:`ssm_tp`, :func:`mla_tp`,
:func:`rglru_tp`: the attention, MLA on its heads, the MLP and an MoE
layer's shared expert, Mamba-2's block and the RG-LRU on its channels,
``models/recurrent.py``): the mesh policy's gather only calls it, and
the step builders read :func:`logits_tp` to know that the logits are a
vocab chunk.  Every collective here counts itself in the
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
    """Forward: the dim ``dim`` all-gathered over the group in rank order.
    Backward: the gradient summed over the group, this rank's chunk."""

    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.group, ctx.rank, ctx.n, ctx.dim = group, rank, x.shape[dim], dim
        return torch.cat(_all_gather(x, group, size), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), \
            None, None, None, None


class _SeqChunk(torch.autograd.Function):
    """Forward: this rank's chunk of dim 1 of ``x`` (whole on every rank
    of the group).  Backward: the chunks' gradients all-gathered (each
    chunk was used on its rank only)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.size = group, size
        n = x.shape[1] // size
        return x[:, rank * n:(rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.group, ctx.size), dim=1), \
            None, None, None


class _SplitWeightGrad(torch.autograd.Function):
    """``x @ w.T`` with ``w`` whole on every rank of the group.  Forward:
    the product.  Backward: ``x``'s gradient whole, and ``w``'s computed
    one chunk of its columns a rank (``1 / size`` of that product) and
    all-gathered over the group, where every rank would compute all of
    it."""

    @staticmethod
    def forward(ctx, x, w, tp):
        ctx.save_for_backward(x, w)
        ctx.tp = tp
        return torch.matmul(x, w.t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        tp = ctx.tp
        n = w.shape[1] // tp.size
        gx = torch.matmul(g, w)
        xs = x.reshape(-1, x.shape[-1])[:, tp.rank * n:(tp.rank + 1) * n]
        gw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), xs)
        return gx, torch.cat(_all_gather(gw, tp.group, tp.size), -1), None


def whole_table_product(x, w):
    """``x @ w.T`` for a table ``w`` whole on 'model' (a vocab the axis
    does not divide): under tensor parallelism with a gradient to take,
    its weight gradient is split over 'model' by columns
    (:class:`_SplitWeightGrad`), as the reference's compiled step splits
    it; else the plain product."""
    tp = current_tp()
    if tp is None or tp.size == 1 or tp.group is None \
            or w.shape[1] % tp.size or not torch.is_grad_enabled() \
            or not w.requires_grad:
        return torch.matmul(x, w.t())
    return _SplitWeightGrad.apply(x, w, tp)


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


def gather_cols(x, tp, dim=-1):
    """The last dim of ``x`` (this rank's columns), or its dim ``dim``,
    all-gathered over 'model'."""
    if tp.size == 1:
        return x
    _needs_group(tp, 'the gather')
    return _GatherCols.apply(x, tp.group, tp.rank, tp.size, dim)


def seq_chunk(x, tp):
    """This rank's chunk of the sequence (dim 1) of ``x``, a tensor whole
    on every rank of 'model' (its gradient gathered back whole)."""
    if tp.size == 1:
        return x
    _needs_group(tp, 'the sequence chunk')
    return _SeqChunk.apply(x, tp.group, tp.rank, tp.size)


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
             'mlp': ('wi', 'wg', 'wo'),
             'shared': ('wi', 'wg', 'wo'),
             'mamba': ('in_proj', 'out_proj', 'conv', 'A_log', 'D',
                       'dt_bias', 'norm'),
             'rglru': ('wgate', 'wx', 'conv', 'w_r', 'w_i', 'lam', 'wo')}
#: MLA's leaves (an ``'attn'`` block with ``wq_b``)
MLA_BLOCK = ('wq_a', 'q_norm', 'wq_b', 'wkv_a', 'kv_norm', 'wk_b', 'wv_b',
             'wo')
_DENSE_KEYS = {'w', 'b', 'w_q', 'scale'}


def block_names(key, node):
    """The leaves of the block ``node`` under ``key`` that have a
    tensor-parallel form (MLA's under ``'attn'``)."""
    if key == 'attn' and isinstance(node, dict) and 'wq_b' in node:
        return MLA_BLOCK
    return TP_BLOCKS.get(key, ())


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


def ssm_tp(cfg, tp):
    """``tp`` where a Mamba-2 block of ``cfg`` computes on its 'model'
    shards (``models/recurrent.py``): its heads, ``in_proj``'s columns and
    the conv's channels each divide the axis, so the rules cut every leaf
    of the block over it; else None.  The caches of such a block are its
    chunks (its heads' state, its chunk of the conv's channels)."""
    if tp is None or cfg is None or 'ssm' not in cfg.block_pattern:
        return None
    d_in = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state, d_in // cfg.ssm_headdim
    if h % tp.size or (2 * d_in + 2 * n + h) % tp.size \
            or (d_in + 2 * n) % tp.size:
        return None
    return tp


def _plain_dense(node, names):
    """Whether each of ``names`` in ``node`` is a plain dense dict (no
    factored form)."""
    return all(isinstance(node.get(k), dict) and ('w' in node[k]
               or 'w_q' in node[k]) and set(node[k]) <= _DENSE_KEYS
               for k in names)


def _ssm_marks(node, tp, cfg):
    """:func:`block_marks` of a Mamba-2 block: ``in_proj`` by columns,
    ``out_proj`` by rows, every other leaf on its 'model' shard."""
    if ssm_tp(cfg, tp) is None:
        return None
    if not _plain_dense(node, ('in_proj', 'out_proj')) \
            or _dense_mark(node['in_proj']) != 'col' \
            or _dense_mark(node['out_proj']) != 'row' \
            or model_dim(node['conv']['w']) != 1 \
            or model_dim(node['A_log']) != 0:
        raise ValueError('a Mamba-2 block the rules do not cut by heads '
                         'on a model axis its heads divide')
    return {'in_proj': 'col', 'out_proj': 'row'}


def mla_tp(cfg, tp):
    """``tp`` where an MLA block of ``cfg`` computes on its heads
    (``models/attention.py``): the heads divide the axis and ``wq_b`` is
    split by columns (``cfg.shard_heads``), so the rules cut ``wq_b``'s
    columns, ``wk_b``/``wv_b``'s heads dim and ``wo``'s rows over it;
    else None.  The latent projections and their norms stay whole on
    every rank."""
    if tp is None or cfg is None or not cfg.use_mla or not cfg.shard_heads \
            or cfg.num_heads % tp.size:
        return None
    return tp


def _mla_marks(node, tp, cfg):
    """:func:`block_marks` of an MLA block: ``wq_b`` by columns, ``wo`` by
    rows, ``wk_b``/``wv_b`` on their heads' shard (unmarked); a factored
    block stays whole."""
    if mla_tp(cfg, tp) is None \
            or not _plain_dense(node, ('wq_a', 'wq_b', 'wkv_a', 'wo')):
        return None
    if _dense_mark(node['wq_b']) != 'col' or _dense_mark(node['wo']) != 'row' \
            or any(_dense_mark(node[k]) for k in ('wq_a', 'wkv_a')) \
            or model_dim(node['wk_b']) != 1 or model_dim(node['wv_b']) != 1:
        raise ValueError('an MLA block the rules do not cut by heads on a '
                         'model axis its heads divide')
    return {'wq_b': 'col', 'wo': 'row'}


def rglru_tp(cfg, tp):
    """``tp`` where an RG-LRU block of ``cfg`` computes on its channels
    (``models/recurrent.py``): its width divides the axis, so the rules
    cut ``wgate``/``wx``/``w_r``/``w_i``'s columns, the conv's channels,
    ``lam`` and ``wo``'s rows over it; else None.  Its decode state is
    then its chunk of the channels."""
    if tp is None or cfg is None or 'recurrent' not in cfg.block_pattern \
            or cfg.rglru_width % tp.size:
        return None
    return tp


_RGLRU_COLS = ('wgate', 'wx', 'w_r', 'w_i')


def _rglru_marks(node, tp, cfg):
    """:func:`block_marks` of an RG-LRU block: ``wgate``, ``wx``, ``w_r``
    and ``w_i`` by columns, ``wo`` by rows, the conv and ``lam`` on their
    channels' shard (unmarked); a factored block stays whole."""
    if rglru_tp(cfg, tp) is None \
            or not _plain_dense(node, _RGLRU_COLS + ('wo',)):
        return None
    if any(_dense_mark(node[k]) != 'col' for k in _RGLRU_COLS) \
            or _dense_mark(node['wo']) != 'row' \
            or model_dim(node['conv']['w']) != 1 \
            or model_dim(node['lam']) != 0:
        raise ValueError('an RG-LRU block the rules do not cut by channels '
                         'on a model axis its width divides')
    return {**{k: 'col' for k in _RGLRU_COLS}, 'wo': 'row'}


def block_marks(key, node, tp, cfg):
    """``{name: 'col' | 'row' | None}`` for the dense dicts of the block
    ``node`` under ``key`` where it computes on its 'model' shards, else
    None (every leaf then gathered whole): a GQA attention, a dense MLP or
    an MoE layer's shared expert of plain dense dicts (no factored form)
    whose ``wo`` 'model' cuts by rows, with an attention's query heads
    whole on each rank; a Mamba-2 block whose heads divide the axis
    (:func:`ssm_tp`), an MLA block whose heads do (:func:`mla_tp`) and an
    RG-LRU block whose width does (:func:`rglru_tp`), their other leaves
    kept on their shards, unmarked."""
    if tp is not None:
        if key == 'mamba':
            return _ssm_marks(node, tp, cfg)
        if key == 'rglru':
            return _rglru_marks(node, tp, cfg)
        if key == 'attn' and 'wq_b' in node:
            return _mla_marks(node, tp, cfg)
    names = TP_BLOCKS.get(key)
    if tp is None or names is None \
            or set(node) - {'wg'} != set(names) - {'wg'} \
            or not all(isinstance(d, dict) and ('w' in d or 'w_q' in d)
                       and set(d) <= _DENSE_KEYS for d in node.values()):
        return None
    marks = {n: _dense_mark(d) for n, d in node.items()}
    if marks['wo'] != 'row':
        return None
    if key in ('attn', 'xattn') and marks['wq'] == 'col' \
            and cfg.num_heads % tp.size:
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


def _cut(t, dim, rank, size):
    """One rank's contiguous chunk of ``t``'s dim ``dim``."""
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def rank_shard(d, mark, rank, size):
    """A whole dense dict cut to one rank's 'model' shard as the sharding
    rules cut it and marked as the mesh policy marks it: ``'col'`` the
    weight's and the bias' last dim, ``'row'`` the weight's first (its
    bias whole), ``'vocab'`` a table's rows."""
    if mark == 'vocab':
        return {'table': _cut(d['table'], 0, rank, size), 'tp': mark}
    if mark == 'col':
        return {**{k: _cut(v, -1, rank, size) for k, v in d.items()},
                'tp': mark}
    return {**d, 'w': _cut(d['w'], 0, rank, size), 'tp': mark}


def mla_rank_shard(p, rank, size):
    """A whole MLA param dict cut to one rank's 'model' shard as the
    sharding rules cut it (``wq_b`` by columns, ``wk_b``/``wv_b`` by
    heads, ``wo`` by rows; the latent projections and norms whole), and
    marked as the mesh policy marks it."""
    return {**p, 'wq_b': rank_shard(p['wq_b'], 'col', rank, size),
            'wk_b': _cut(p['wk_b'], 1, rank, size),
            'wv_b': _cut(p['wv_b'], 1, rank, size),
            'wo': rank_shard(p['wo'], 'row', rank, size)}


def rglru_rank_shard(p, rank, size):
    """A whole RG-LRU param dict cut to one rank's 'model' shard as the
    sharding rules cut it (its channels: ``wgate``, ``wx``, ``w_r``,
    ``w_i`` by columns, the conv and ``lam``, ``wo`` by rows), and marked
    as the mesh policy marks it."""
    return {**{k: rank_shard(p[k], 'col', rank, size) for k in _RGLRU_COLS},
            'conv': {k: _cut(v, -1, rank, size)
                     for k, v in p['conv'].items()},
            'lam': _cut(p['lam'], -1, rank, size),
            'wo': rank_shard(p['wo'], 'row', rank, size)}
