"""Transformer assembly of the LM side: the reference's
``models/transformer.py`` (decoder LM, VLM with a frontend prefix,
encoder-decoder; GQA or MLA attention, RG-LRU or SSD blocks; dense MLP or
MoE feed-forward), in PyTorch.

Layers are grouped as in the reference into (prefix, scanned groups,
tail), and the param and cache trees keep that shape: ``params['blocks']``
is a list of ``P`` layer trees whose leaves are stacked ``(G, ...)`` over
the groups, and the cache is ``{'prefix', 'blocks', 'tail'}`` with the
same stacking, so a JAX tree crosses through numpy unchanged.  The
reference's ``jax.lax.scan`` over the groups is a Python loop over the
stacked leading axis (each step takes views ``leaf[g]``).

Three entry points: :func:`forward` (logits), :func:`prefill` (forward
and cache build) and :func:`decode_step` (one token), plus :func:`encode`
for an encoder-decoder.  ``embeds`` (B, F, d) is a frontend prefix (a
VLM's patch embeddings) placed before the token embeddings; ``enc`` and
``enc_pos`` are the encoder output and its positions, which every decoder
layer of an encoder-decoder cross-attends to (``'norm_x'``/``'xattn'``).
``ctx`` carries injected functions (``'decode_attn'``, ``'decode_mla'``)
as in the reference.  The cache is written in place (see
``models/attention.py``).

MoE: the leading ``first_dense_layers`` (the prefix) keep a dense MLP and
every later layer of an MoE config has ``'moe'`` in its place
(:func:`_is_moe_layer`); MLA (``cfg.use_mla``) replaces the GQA attention
of every layer, and its cache holds the latent and the rope key.

Recurrent blocks (``models/recurrent.py``): a ``'recurrent'`` layer
(recurrentgemma) has an RG-LRU (``'rglru'``) where an attention layer has
``'attn'``, and its MLP; an ``'ssm'`` layer (mamba2) has a Mamba-2 block
(``'mamba'``) and no MLP and no ``norm2``.  Their caches are the decode
states ``{'h', 'conv'}``, written in place like the attention caches; a
prefill fills them from the scan's last state and the conv's last inputs.

``shard_act`` marks the layer boundaries where the reference calls it
(the identity unless a policy is installed, ``models/actsharding.py``),
and :func:`~repro_torch.models.actsharding.gather_params` runs on each
layer's param tree just before the layer (and on the embedding, the final
norm and the unembedding): the identity unless the launcher's mesh policy
is installed, which then gathers a sharded leaf to its full tensor, or
to its 'model' shard in a block with a tensor-parallel form
(``launch/steps.py``, ``models/tp.py``): the logits are then this rank's
vocab chunk.
``remat=True`` runs each layer of :func:`forward`'s scanned groups (and
of an encoder) under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``, the gather inside it: the numbers are the same,
the activations kept for the backward pass are each layer's input only,
and a sharded leaf is gathered again for the recomputation.  The
reference checkpoints each scanned group and neither the prefix nor the
tail; the port's groups are a Python loop, so each of their layers is
its own checkpoint, and the prefix and tail layers keep their
activations, as the reference's do (the same FLOPs: a recomputed prefix
layer is one more forward of it).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models.actsharding import gather_params, shard_act
from repro_torch.models.layers import (embed, init_embedding, init_mlp,
                                       init_norm, mlp, rms_norm, softcap,
                                       unembed)
from repro_torch.tree import tree_map

# ---------------------------------------------------------------- structure


def layer_groups(cfg: ModelConfig):
    """(n_prefix, n_groups, pattern_len, n_tail) split of the layer stack."""
    P = len(cfg.block_pattern)
    n_prefix = cfg.first_dense_layers
    rest = cfg.num_layers - n_prefix
    return n_prefix, rest // P, P, rest % P


def _is_moe_layer(cfg, abs_idx):
    return cfg.is_moe and abs_idx >= cfg.first_dense_layers


def torch_dtype(name: str) -> torch.dtype:
    return {'bfloat16': torch.bfloat16, 'float32': torch.float32}[name]


def _at(tree, g: int):
    """The g-th slice of every stacked leaf (views: writes reach the
    stack)."""
    return tree_map(lambda t: t[g], tree)


def _layers(tree, cfg):
    """``(kind, layer tree)`` for every layer in order: prefix, the scanned
    groups (views into the stacked leaves) and tail."""
    n_prefix, G, P, _ = layer_groups(cfg)
    kinds = cfg.layer_kinds()
    out = [(kinds[i], t) for i, t in enumerate(tree['prefix'])]
    for g in range(G):
        out += [(kinds[n_prefix + g * P + j], _at(tree['blocks'][j], g))
                for j in range(P)]
    tail_base = n_prefix + G * P
    out += [(kinds[tail_base + i], t) for i, t in enumerate(tree['tail'])]
    return out


# --------------------------------------------------------------------- init


def _init_layer(gen, cfg, kind, *, moe_layer, dtype, device, stack=(),
                cross=False):
    kw = dict(dtype=dtype, device=device, stack=stack)
    p = {'norm1': init_norm(cfg.d_model, **kw)}
    if kind in ('global', 'local', 'encoder'):
        p['attn'] = (attn.init_mla if cfg.use_mla
                     else attn.init_attention)(gen, cfg, **kw)
    elif kind == 'recurrent':
        p['rglru'] = rec.init_rglru(gen, cfg, **kw)
    elif kind == 'ssm':
        p['mamba'] = rec.init_mamba2(gen, cfg, **kw)
        return p                                   # mamba block has no MLP
    else:
        raise ValueError(kind)
    if cross:
        p['norm_x'] = init_norm(cfg.d_model, **kw)
        p['xattn'] = attn.init_attention(gen, cfg, **kw)
    p['norm2'] = init_norm(cfg.d_model, **kw)
    if moe_layer:
        p['moe'] = moe_lib.init_moe(gen, cfg, **kw)
    else:
        p['mlp'] = init_mlp(gen, cfg, gated=cfg.family != 'audio', **kw)
    return p


def init_lm(gen: torch.Generator, cfg: ModelConfig, device='cpu'):
    """Random params drawn from ``gen`` (a generator on ``device``): the
    full-width weights of a served model are made where they live."""
    dtype = torch_dtype(cfg.dtype)
    n_prefix, G, P, R = layer_groups(cfg)
    kinds = cfg.layer_kinds()
    kw = dict(dtype=dtype, device=device)
    params = {'embed': init_embedding(gen, cfg.vocab_size, cfg.d_model, **kw),
              'final_norm': init_norm(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params['unembed'] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           **kw)
    cross = cfg.arch_kind == 'encdec'
    params['prefix'] = [_init_layer(gen, cfg, kinds[i], moe_layer=False,
                                    cross=cross, **kw)
                        for i in range(n_prefix)]
    params['blocks'] = [
        _init_layer(gen, cfg, kinds[n_prefix + j],
                    moe_layer=_is_moe_layer(cfg, n_prefix + j), stack=(G,),
                    cross=cross, **kw)
        for j in range(P)] if G else []
    tail_base = n_prefix + G * P
    params['tail'] = [_init_layer(gen, cfg, kinds[tail_base + i],
                                  moe_layer=_is_moe_layer(cfg, tail_base + i),
                                  cross=cross, **kw) for i in range(R)]
    if cross:
        params['encoder'] = {
            'layers': [_init_layer(gen, cfg, 'encoder', moe_layer=False, **kw)
                       for _ in range(cfg.num_encoder_layers)],
            'final_norm': init_norm(cfg.d_model, **kw)}
    return params


# ------------------------------------------------------------ layer forward


def _ffn(lp, h, cfg, quant):
    if 'moe' in lp:
        return moe_lib.moe_block(lp['moe'], h, cfg, quant=quant)
    return mlp(lp['mlp'], h, quant=quant)


def layer_forward(lp, x, kind, cfg, *, positions, quant, enc=None,
                  enc_pos=None, want_cache=False):
    """Full-sequence layer.  Returns (x, cache entries | None): (k, v),
    MLA's (ckv, k_rope), RG-LRU's state dict or SSD's (state, conv
    tail)."""
    h = rms_norm(lp['norm1'], x, cfg.norm_eps)
    if kind == 'ssm':
        o = rec.mamba2_forward(lp['mamba'], h, cfg, quant=quant,
                               return_state=want_cache)
        return (x + o[0], o[1]) if want_cache else (x + o, None)
    if kind == 'recurrent':
        o = rec.rglru_forward(lp['rglru'], h, cfg, quant=quant,
                              return_state=want_cache)
        o, kvs = o if want_cache else (o, None)
    elif cfg.use_mla:
        o, kvs = attn.mla_forward(
            lp['attn'], h, positions, cfg, quant=quant,
            seq_split='moe' in lp and moe_lib.splits_sequence(lp['moe'], h,
                                                              cfg))
    else:
        o, kvs = attn.gqa_forward(lp['attn'], h, positions, cfg, kind=kind,
                                  quant=quant, full_kv=want_cache)
    x = x + o
    del h, o             # with no gradient to take, their memory goes now
    if 'xattn' in lp:
        hx = rms_norm(lp['norm_x'], x, cfg.norm_eps)
        o, _ = attn.gqa_forward(lp['xattn'], hx, positions, cfg, kind='cross',
                                quant=quant, kv=(enc, enc_pos), full_kv=False)
        x = x + o
    x = x + _ffn(lp, rms_norm(lp['norm2'], x, cfg.norm_eps), cfg, quant)
    return x, (kvs if want_cache else None)


def layer_decode(lp, x, kind, cfg, *, cur, cache, ctx, quant, enc=None,
                 enc_pos=None):
    """One-token layer step.  x: (B, d).  Returns (x, cache)."""
    h = rms_norm(lp['norm1'], x, cfg.norm_eps)
    if kind == 'ssm':
        o, c = rec.mamba2_decode(lp['mamba'], h, cache, cfg, quant=quant)
        return x + o, c
    if kind == 'recurrent':
        o, c = rec.rglru_decode(lp['rglru'], h, cache, cfg, quant=quant)
    elif cfg.use_mla:
        o, c = attn.mla_decode(lp['attn'], h, cur, cfg, cache=cache, ctx=ctx,
                               quant=quant)
    else:
        o, c = attn.gqa_decode(lp['attn'], h, cur, cfg, kind=kind,
                               cache=cache, ctx=ctx, quant=quant)
    x = x + o
    if 'xattn' in lp:
        hx = rms_norm(lp['norm_x'], x, cfg.norm_eps)
        x = x + attn.gqa_cross_decode(lp['xattn'], hx, enc, enc_pos, cfg,
                                      quant=quant)
    x = x + _ffn(lp, rms_norm(lp['norm2'], x[:, None], cfg.norm_eps), cfg,
                 quant)[:, 0]
    return x, c


# ----------------------------------------------------------- cache builders


def init_layer_cache(cfg, kind, batch, max_len, dtype, device='cpu',
                     ctx=None):
    """A ``kind`` layer's empty cache; ``ctx`` (:func:`prefill`'s) makes
    it this rank's chunk."""
    ctx = ctx or {}
    chunk = ctx.get('cache_chunk')
    if kind == 'ssm':
        return rec.init_mamba2_cache(cfg, batch, dtype, device,
                                     tp=ctx.get('ssm_tp'))
    if kind == 'recurrent':
        return rec.init_rglru_cache(cfg, batch, dtype, device,
                                    tp=ctx.get('rglru_tp'))
    if cfg.use_mla:
        return attn.init_mla_cache(cfg, batch, max_len, dtype, device,
                                   chunk=chunk)
    return attn.init_attn_cache(cfg, batch, kind, max_len, dtype, device,
                                chunk=chunk)


def init_cache(cfg: ModelConfig, batch, max_len, device='cpu', ctx=None):
    """The empty cache tree; with ``ctx`` (:func:`prefill`'s) this rank's
    chunk of each leaf that ``ctx`` cuts."""
    dtype = torch_dtype(cfg.dtype)
    n_prefix, G, P, R = layer_groups(cfg)
    kinds = cfg.layer_kinds()

    def one(kind):
        return init_layer_cache(cfg, kind, batch, max_len, dtype, device,
                                ctx)

    def stacked(kind):
        return tree_map(lambda a: a.expand((G,) + a.shape).clone(),
                        one(kind))

    tail_base = n_prefix + G * P
    return {
        'prefix': [one(kinds[i]) for i in range(n_prefix)],
        'blocks': [stacked(kinds[n_prefix + j]) for j in range(P)]
        if G else [],
        'tail': [one(kinds[tail_base + i]) for i in range(R)],
    }


def _fill_cache(cfg, kind, cache, kvs, positions, max_len, chunk=None):
    """Insert prefill outputs into an empty cache entry (in place).  A
    recurrent layer's state replaces its zeros.  ``chunk``: the cache is
    this rank's chunk of its ring (:func:`prefill`)."""
    if kind == 'ssm':
        kvs = {'h': kvs[0], 'conv': kvs[1]}
    if kind in ('ssm', 'recurrent'):
        for k, t in kvs.items():
            cache[k].copy_(t)
        return cache
    n = max_len if cfg.use_mla else attn.ring_slots(cfg, kind, max_len)
    c = chunk(n) if chunk is not None else None
    c = None if c is None else (*c, n)
    if cfg.use_mla:
        return attn.prefill_mla_cache_write(cache, kvs[0], kvs[1], positions,
                                            chunk=c)
    return attn.prefill_cache_write(cache, kvs[0], kvs[1], positions,
                                    chunk=c)


# ------------------------------------------------------------------ forward


def _head(params, cfg, x, quant):
    """Logits of ``x``: on a vocab shard this rank's chunk of the vocab."""
    x = rms_norm(gather_params(params['final_norm']), x, cfg.norm_eps)
    logits = unembed(gather_params(params.get('unembed', params['embed'])),
                     x, quant=quant)
    return softcap(logits, cfg.logit_softcap)


def _embed(params, cfg, tokens, embeds):
    """Token embeddings, after the frontend prefix ``embeds`` if given."""
    dtype = torch_dtype(cfg.dtype)
    x = shard_act(embed(gather_params(params['embed']), tokens, dtype))
    if embeds is not None:
        x = torch.cat([embeds.to(dtype), x], dim=1)
    return x


def encode(params, cfg: ModelConfig, frames, *, remat=False):
    """The encoder over (stubbed) frame embeddings (B, F, d): non-causal
    layers, then its final norm.  ``remat``: checkpoint each layer, as
    :func:`forward` does the decoder's."""
    x = frames.to(torch_dtype(cfg.dtype))
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    quant = (cfg.w_bits, cfg.a_bits)

    def apply_one(lp, x):
        return layer_forward(gather_params(lp), x, 'encoder', cfg,
                             positions=pos, quant=quant)[0]

    for lp in params['encoder']['layers']:
        x = (checkpoint(apply_one, lp, x, use_reentrant=False) if remat
             else apply_one(lp, x))
    return rms_norm(gather_params(params['encoder']['final_norm']), x,
                    cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, embeds=None, enc=None,
            enc_pos=None, remat=False, collect_hiddens=False):
    """Logits (B, S, vocab) of a token batch (B, S); with a frontend prefix
    ``embeds`` (B, F, d), logits of the whole (B, F + S) sequence.

    ``remat``: checkpoint each layer of the scanned groups (recompute it
    in the backward pass), as the reference checkpoints its scan body.
    ``collect_hiddens``: also return the residual stream after each scan
    group (``hiddens[g]``, (B, S, d), before the tail and the final norm),
    the early-exit heads' inputs: ``(logits, hiddens)``.  The reference
    stacks them into (G, B, S, d); the list indexes the same way."""
    quant = (cfg.w_bits, cfg.a_bits)
    x = _embed(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    n_prefix, G, P, _ = layer_groups(cfg)
    group_ends = {n_prefix + (g + 1) * P - 1 for g in range(G)}

    def apply_one(lp, x, kind):
        y, _ = layer_forward(gather_params(lp), x, kind, cfg,
                             positions=positions, quant=quant, enc=enc,
                             enc_pos=enc_pos)
        return shard_act(y)

    hiddens = []
    scanned = range(n_prefix, n_prefix + G * P)
    for i, (kind, lp) in enumerate(_layers(params, cfg)):
        if remat and i in scanned:
            x = checkpoint(apply_one, lp, x, kind, use_reentrant=False)
        else:
            x = apply_one(lp, x, kind)
        if collect_hiddens and i in group_ends:
            hiddens.append(x)
    logits = shard_act(_head(params, cfg, x, quant), 'logits')
    return (logits, hiddens) if collect_hiddens else logits


def prefill(params, cfg: ModelConfig, tokens, *, embeds=None, enc=None,
            enc_pos=None, max_len=None, ctx=None):
    """Forward and cache build.  Returns (last logits (B, vocab), cache).

    ``ctx`` (a mesh step's, ``launch/serving.make_prefill_ctx``) makes the
    cache this rank's chunk: ``'cache_chunk'`` maps a ring's slots to
    (first slot, slots) of this rank's chunk, or None for the whole ring;
    ``'ssm_tp'`` is the model axis a Mamba-2 block's state is cut over
    by heads, ``'rglru_tp'`` the one an RG-LRU block's is cut over by
    channels.  Each layer's k/v (or latent) goes into the chunk as the
    layer ends and is dropped: one layer's whole-sequence k/v is live at
    a time."""
    quant = (cfg.w_bits, cfg.a_bits)
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    max_len = max_len or cfg.max_seq_len
    cache = init_cache(cfg, B, max_len, x.device, ctx=ctx)
    chunk = (ctx or {}).get('cache_chunk')
    for (kind, lp), (_, centry) in zip(_layers(params, cfg),
                                       _layers(cache, cfg)):
        x, kvs = layer_forward(gather_params(lp), x, kind, cfg,
                               positions=positions, quant=quant, enc=enc,
                               enc_pos=enc_pos, want_cache=True)
        if kind not in ('ssm', 'recurrent'):
            x = shard_act(x)
        _fill_cache(cfg, kind, centry, kvs, positions, max_len, chunk)
        del kvs
    return _head(params, cfg, x[:, -1:], quant)[:, 0], cache


def decode_step(params, cfg: ModelConfig, token, cur, cache, *, ctx=None,
                enc=None, enc_pos=None):
    """One decode step.  token: (B,) int; cur: the position (a Python int,
    or a 0-dim tensor read with ``int()``); ``enc``/``enc_pos`` the encoder
    output of an encoder-decoder.  Returns (logits (B, vocab), cache), the
    cache written in place."""
    ctx = ctx or {}
    cur = int(cur)
    quant = (cfg.w_bits, cfg.a_bits)
    x = shard_act(embed(gather_params(params['embed']), token,
                        torch_dtype(cfg.dtype)), 'residual1')
    for (kind, lp), (_, centry) in zip(_layers(params, cfg),
                                       _layers(cache, cfg)):
        x, _ = layer_decode(gather_params(lp), x, kind, cfg, cur=cur,
                            cache=centry, ctx=ctx, quant=quant, enc=enc,
                            enc_pos=enc_pos)
        x = shard_act(x, 'residual1')
    return _head(params, cfg, x, quant), cache
