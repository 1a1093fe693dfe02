"""Step builders: train_step / prefill_step / serve_step over a DeviceMesh
(the reference's ``launch/steps.py``).

Each builder returns ``(fn, model, abstract args)`` as the reference's
does; the abstract params and states are tensors on the ``meta`` device
(shapes and dtypes, never allocated), and the shardings are
``launch.sharding.NamedSharding`` trees built by the reference's rules.

Storage follows the reference's specs exactly: params FSDP over the DP
axes and TP on 'model', the AdamW moments under ZeRO-1, the batch over the
DP axes, the decode caches sequence-sharded.  Every state leaf is a
DTensor.  A plain tensor given where the reference's jit would reshard
(the whole array, the same on every rank) is placed the same way: each
rank keeps its chunk.

Compute is one program per rank on local tensors (where the reference's
GSPMD partitions one program), on this rank's chunk of the batch:

* each layer's leaves are gathered over the DP axes just before the layer
  runs (``models/actsharding.py``'s mesh policy, through the model's
  ``gather_params`` hook: the all-gathers GSPMD inserts per layer);
* on 'model' the dense blocks compute tensor-parallel
  (``models/tp.py``): the attention on this rank's heads (``wq``/``wk``/
  ``wv`` by columns, ``wo`` by rows, its part all-reduced over 'model';
  where 'model' cuts a kv head, that layer's k/v are all-gathered over
  'model'), the MLP on its columns of the hidden dim (``wo``'s part
  all-reduced), the embedding on its vocab rows (a masked lookup,
  all-reduced) and the logits on its vocab chunk: the loss is the
  vocab-parallel cross-entropy (the max, the sum of exponentials and the
  label's logit all-reduced over 'model'), and no rank holds a whole
  (B, S, V) logits tensor.  The prefill and the decode take the greedy
  token from the vocab chunks (each rank's max and its index gathered
  over 'model'); the prefill gathers the k/v heads the cache holds
  (sequence-sharded over 'model', every head on every rank); the decode
  gathers its q/k/v
  heads and runs ``wo`` on this rank's rows.  Every other 'model' leaf
  (MLA's, the RG-LRU's, Mamba-2's, the causal conv) is gathered whole
  (ROADMAP A 12);
* gradients go back to each leaf's placement: summed over the DP axes,
  divided by their size (the global batch's mean), this rank's chunk;
* the global-norm clip reads the sum of squares over all shards (each
  leaf's local sum, summed over the mesh dims that shard it);
* AdamW (weight decay 0.1, ``clip_by_global_norm(1.0)``) updates the
  local shards in place, the single-device form of the reference's
  donated buffers: under ZeRO-1 a rank updates its chunk of the moments
  and the update is gathered back to the param's placement;
* the loss is the mean over every rank's tokens (a VLM's over its text
  positions only).

The MoE block runs expert-parallel (``models/moe.py``), its expert
leaves gathered over the DP axes only and kept on their 'model' shards.
On a mesh of one rank every placement is ``Replicate()``, the policy has
no tensor-parallel axis, no collective runs but the MoE block's (over
groups of one), and the step computes the single-device step's numbers.
The decode runs the plain decode math through ``launch/serving.py``'s
ctx, as the reference's mesh path does, not the decode-attention
kernel.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import data_axes, mesh_axes
from repro_torch.launch.serving import (cache_dims, decode_spec,
                                        make_decode_ctx)
from repro_torch.models.actsharding import (LocalShard, activation_sharding,
                                            make_mesh_policy)
from repro_torch.models.model import build_model
from repro_torch.models.tp import logits_tp, vocab_argmax, vocab_parallel_ce
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


def _ce_loss(logits, labels):
    lp = torch.log_softmax(logits.to(torch.float32), -1)
    ce = -torch.gather(lp, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(ce)


def abstract_params(model):
    """The param tree as ``meta`` tensors: shapes and dtypes, no memory."""
    return model.init(torch.Generator(), 'meta')


# ----------------------------------------------------------------- placing


def place(x, s):
    """``x`` on the NamedSharding ``s`` as a DTensor: a DTensor already
    there as it is, one elsewhere redistributed (gathered first if on
    another mesh), a plain tensor (the whole array) cut to this rank's
    chunk."""
    if isinstance(x, DTensor):
        if x.device_mesh is s.mesh:
            if tuple(x.placements) == s.placements:
                return x
            return x.redistribute(s.mesh, s.placements)
        x = x.full_tensor()
    return s.place(torch.as_tensor(x))


def place_tree(tree, shardings):
    return tree_map(place, tree, shardings)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _from_local(t, mesh, spec, like):
    """A DTensor of ``like``'s global shape holding this rank's ``t``."""
    return DTensor.from_local(t, mesh, sh.placements(spec, mesh),
                                 run_check=False, shape=like.shape,
                                 stride=like.stride())


def _as(x, s_from, s_to):
    """This rank's chunk under ``s_to`` of the tensor whose chunk under
    ``s_from`` is the plain tensor ``x`` (local where ``s_to`` only cuts
    ``s_from`` finer, an all-gather where it is coarser)."""
    if s_from.placements == s_to.placements:
        return x
    D = DTensor
    out = D.from_local(x, s_from.mesh, s_from.placements,
                       run_check=False).redistribute(
        s_to.mesh, s_to.placements).to_local()
    return out.wait() if hasattr(out, 'wait') else out


def _shards(params, p_sh, grad=False):
    """The params as :class:`LocalShard` leaves (this rank's chunks, with
    ``requires_grad`` for a training step) and the list of those chunks."""
    def one(x, s):
        t = _local(x)
        if grad:
            t = t.detach().requires_grad_()
        return LocalShard(t, s.mesh, s.placements)
    shards = tree_map(one, params, p_sh)
    return shards, [x.local for x in tree_leaves(shards)]


def _local_batch(batch, b_sh):
    """This rank's chunk of every leaf of ``batch`` (whole tensors, the
    same on every rank, or DTensors), on the mesh's device."""
    return tree_map(lambda x, s: _local(place(x, s)), batch, b_sh)


def _batch_split(spec, mesh) -> bool:
    """The batch spec ``spec`` splits dim 0 over every DP axis (the
    reference's ``B % dp == 0``, which its MoE block tests before its
    expert-parallel path)."""
    first = tuple(spec)[0] if len(spec) else None
    return set(sh._axes(first)) == set(data_axes(mesh))


def _dp_mean(x, mesh):
    """The mean of ``x`` over the DP ranks (in place)."""
    import torch.distributed as dist
    from repro_torch.kernels.ref import true_div
    n = 1
    for a in data_axes(mesh):
        g = mesh.get_group(a)
        if dist.get_world_size(g) > 1:
            dist.all_reduce(x, group=g)
            n *= dist.get_world_size(g)
    return true_div(x, float(n)) if n > 1 else x


def _global_norm(grads, shardings, mesh, counts):
    """sqrt of the sum of squares of every leaf over all its shards: each
    leaf's local sum in fp32 in tree order, summed over the mesh dims that
    shard it (each all-reduce noted as ``'grad_norm'`` in ``counts``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.models.actsharding import note
    by_dims = {}
    for g, s in zip(grads, shardings):
        dims = tuple(i for i, p in enumerate(s.placements)
                     if isinstance(p, Shard))
        sq = torch.sum(torch.square(g.to(torch.float32)))
        by_dims[dims] = sq if dims not in by_dims else by_dims[dims] + sq
    total = None
    for dims, sq in by_dims.items():
        for i in dims:
            if mesh.size(i) > 1:
                note('grad_norm', sq, mesh.mesh_dim_names[i], counts)
                dist.all_reduce(sq, group=mesh.get_group(i))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# -------------------------------------------------------------- train step


def build_train_step(cfg, mesh, batch_aval, *, lr=3e-4, remat=True,
                     zero1=True, fsdp=True):
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    (``metrics``: the global mean ``'loss'`` and the pre-clip
    ``'grad_norm'``), the model, and (abstract params, abstract opt state,
    param shardings, opt-state shardings).  ``fn.policy`` is the step's
    mesh policy (its ``counts``)."""
    model = build_model(cfg)
    opt = adamw(lr, weight_decay=0.1)
    p_aval = abstract_params(model)
    p_sh = sh.params_shardings(p_aval, cfg, mesh, fsdp=fsdp)
    o_aval = opt.init(p_aval)
    o_sh = (sh.zero1_shardings(o_aval, p_sh, mesh) if zero1 else
            AdamWState(step=sh.NamedSharding(mesh, sh.P()), mu=p_sh,
                       nu=p_sh))
    b_sh = sh.batch_shardings(batch_aval, mesh)
    policy = make_mesh_policy(
        mesh, batch_split=_batch_split(b_sh['tokens'].spec, mesh), cfg=cfg)
    p_flat, m_flat = tree_leaves(p_sh), tree_leaves(o_sh.mu)

    def train_step(params, opt_state, batch):
        params = place_tree(params, p_sh)
        opt_state = place_tree(opt_state, o_sh)
        local = _local_batch(batch, b_sh)
        shards, leaves = _shards(params, p_sh, grad=True)
        with activation_sharding(policy):
            logits = model.forward(shards, local, remat=remat)
            labels = local['labels']
            if cfg.arch_kind == 'vlm':   # loss only over text positions
                logits = logits[:, -labels.shape[1]:]
            vocab = logits_tp(shards, policy.tp)
            loss = (vocab_parallel_ce(logits, labels, vocab) if vocab
                    else _ce_loss(logits, labels))
            del logits
            # inside the policy: remat recomputes each layer, and its
            # gather, in the backward pass
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        del shards
        with torch.no_grad():
            loss = _dp_mean(loss.detach().clone(), mesh)
            gnorm = _global_norm(grads, p_flat, mesh, policy.counts)
            scale = torch.clamp(
                torch.full((), 1.0, dtype=torch.float32, device=gnorm.device)
                / torch.clamp_min(gnorm, 1e-9), max=1.0)
            p_dt, mu, nu = (tree_leaves(params), tree_leaves(opt_state.mu),
                            tree_leaves(opt_state.nu))
            g_m, p_m = [], []
            for g, p, ps, ms in zip(grads, p_dt, p_flat, m_flat):
                # in place: a second copy of the gradients beside the
                # moments and the updates does not fit at full width
                g = g.mul_(scale.to(g.dtype))
                g_m.append(_as(g, ps, ms))
                p_m.append(_as(p.to_local(), ps, ms))
            step = opt_state.step
            updates, new = opt.update(
                g_m, AdamWState(step=_local(step),
                                mu=[m.to_local() for m in mu],
                                nu=[v.to_local() for v in nu]), p_m)
            for u, p, ps, ms in zip(updates, p_dt, p_flat, m_flat):
                p.to_local().add_(_as(u, ms, ps))
            opt_state = AdamWState(
                step=_from_local(new.step, mesh, sh.P(), step),
                mu=opt_state.mu, nu=opt_state.nu)
        return params, opt_state, {'loss': loss, 'grad_norm': gnorm}

    train_step.policy = policy
    return train_step, model, (p_aval, o_aval, p_sh, o_sh)


# ------------------------------------------------------------ prefill step


def _cache_from_local(cache, mesh, batch_entry, c_sh):
    """A rank's whole-sequence cache of its batch chunk (the tokens' batch
    spec ``batch_entry``) -> DTensors on the cache shardings ``c_sh``
    (each rank keeps its sequence chunk)."""
    sizes = mesh_axes(mesh)

    def one(path, t, s):
        b_dim = cache_dims(path)[0]
        spec = [None] * t.dim()
        shape = list(t.shape)
        if b_dim is not None and batch_entry is not None:
            spec[b_dim] = batch_entry
            shape[b_dim] *= math.prod(sizes[a] for a in sh._axes(batch_entry))
        out = DTensor.from_local(t, mesh, sh.placements(sh.P(*spec), mesh),
                                    run_check=False, shape=torch.Size(shape),
                                    stride=torch.empty(shape,
                                                       device='meta').stride())
        return place(out, s)
    return tree_map_with_path(one, cache, c_sh)


def _greedy(logits, vocab):
    """The greedy tokens of the logits, a vocab chunk on ``vocab``'s
    ranks (None: the whole vocab)."""
    tok = vocab_argmax(logits, vocab) if vocab else torch.argmax(logits, -1)
    return tok.to(torch.int32)


def build_prefill_step(cfg, mesh, batch_aval, *, max_len, fsdp=True):
    """``fn(params, batch) -> (greedy tokens, cache)``: the prompt's
    forward and its cache on the cache shardings (sequence over 'model')."""
    model = build_model(cfg)
    p_aval = abstract_params(model)
    p_sh = sh.params_shardings(p_aval, cfg, mesh, fsdp=fsdp)
    b_sh = sh.batch_shardings(batch_aval, mesh)
    n = batch_aval['tokens'].shape[0]
    c_aval = model.init_cache(n, max_len, 'meta')
    c_sh = sh.cache_shardings(c_aval, cfg, mesh, long_ctx=False)
    tok_sh = sh.NamedSharding(mesh, sh.batch_spec((n,), mesh))
    tok_aval = torch.empty((n,), dtype=torch.int32, device='meta')
    policy = make_mesh_policy(
        mesh, batch_split=_batch_split(b_sh['tokens'].spec, mesh), cfg=cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        params = place_tree(params, p_sh)
        local = _local_batch(batch, b_sh)
        shards, _ = _shards(params, p_sh)
        with activation_sharding(policy):
            logits, cache = model.prefill(shards, local, max_len=max_len)
            tok = _greedy(logits, logits_tp(shards, policy.tp))
        entry = tuple(tok_sh.spec)[0] if len(tok_sh.spec) else None
        return (_from_local(tok, mesh, tok_sh.spec, tok_aval),
                _cache_from_local(cache, mesh, entry, c_sh))

    prefill_step.policy = policy
    return prefill_step, model, (p_aval, p_sh)


# -------------------------------------------------------------- serve step


def build_serve_step(cfg, mesh, *, batch, max_len, long_ctx=False,
                     fsdp=True, int8_weights=False):
    """One-token decode step: greedy-sample next token, update cache.

    ``fn(params, token, cur, cache, enc=None) -> (tokens, cache)``, ``cur``
    the position as a Python int.  ``int8_weights``: serve with
    int8-quantized matmul weights (the paper's Q pass at inference).
    ``fsdp=False`` keeps weights TP-sharded and resident.  The cache is
    moved to the decode layout (``launch/serving.decode_spec``; only the
    int8 scales and the recurrent states change placement), decoded in
    place on each rank's chunks, and returned on the cache shardings."""
    model = build_model(cfg)
    p_aval = abstract_params(model)
    if int8_weights:
        from repro_torch.core.quantization import quantize_params_for_serving
        p_aval = quantize_params_for_serving(p_aval)
    p_sh = sh.params_shardings(p_aval, cfg, mesh, fsdp=fsdp)
    c_aval = model.init_cache(batch, max_len, 'meta')
    c_sh = sh.cache_shardings(c_aval, cfg, mesh, long_ctx=long_ctx)
    d_sh = tree_map_with_path(
        lambda p, x: sh.NamedSharding(mesh, decode_spec(
            p, x, mesh, long_ctx=long_ctx)), c_aval)
    ctx = make_decode_ctx(mesh, cfg, long_ctx=long_ctx, max_len=max_len)
    tok_sh = sh.NamedSharding(mesh, sh.batch_spec((batch,), mesh))
    enc_sh = None
    avals = [p_aval, torch.empty((batch,), dtype=torch.int32, device='meta'),
             0, c_aval]
    if cfg.arch_kind == 'encdec':
        from repro_torch.models.transformer import torch_dtype
        enc_aval = torch.empty((batch, cfg.frontend_tokens, cfg.d_model),
                               dtype=torch_dtype(cfg.dtype), device='meta')
        enc_sh = sh.NamedSharding(mesh, sh.batch_spec(enc_aval.shape, mesh))
        avals.append(enc_aval)
    policy = make_mesh_policy(mesh,
                              batch_split=_batch_split(tok_sh.spec, mesh),
                              cfg=cfg)

    @torch.no_grad()
    def serve_step(params, token, cur, cache, enc=None):
        params = place_tree(params, p_sh)
        token = _local_batch(token, tok_sh)
        if enc is not None:
            enc = _local_batch(enc, enc_sh)
        cache = place_tree(place_tree(cache, c_sh), d_sh)
        shards, _ = _shards(params, p_sh)
        with activation_sharding(policy):
            logits, _ = model.decode_step(shards, token, cur,
                                          tree_map(_local, cache), enc=enc,
                                          ctx=ctx)
            tok = _greedy(logits, logits_tp(shards, policy.tp))
        return (_from_local(tok, mesh, tok_sh.spec, avals[1]),
                place_tree(cache, c_sh))

    in_sh = [p_sh, tok_sh, None, c_sh] + ([enc_sh] if enc_sh else [])
    serve_step.policy = policy
    return serve_step, model, (avals, in_sh)
