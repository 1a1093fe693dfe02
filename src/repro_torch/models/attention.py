"""Attention of the LM side: GQA (global, sliding-window, encoder and
cross-attention) and MLA (deepseek-v3), in PyTorch.

The reference's ``models/attention.py``:

* train/prefill — :func:`chunked_attention`, online-softmax attention over
  KV chunks in plain torch, as the reference writes it in plain JAX (the
  ``jax.lax.scan`` over chunks is a Python loop);
* decode — one token against a cache.  :func:`gqa_decode` takes
  ``ctx.get('decode_attn', ...)`` as the reference does.  The port's
  default, :func:`decode_attn_kernel`, writes the new k/v into the ring
  slot and runs ``ops.decode_attention`` (``ops.decode_attention_int8``
  for an int8 cache) over the whole cache, the attention softcap
  (gemma2) inside the kernel: the hand-written kernel on a CUDA tensor,
  its plain version on a CPU tensor.
  :func:`decode_attn_reference` is the reference's single-device math in
  plain torch, kept for comparison;
* MLA — :func:`mla_forward` attends with :func:`chunked_attention` over
  k and v up-projected from the compressed latent (q/k head dim
  rope + nope, v head dim its own); :func:`mla_decode` absorbs the
  up-projections into q and the output, and attends in the latent space
  over a cache of the latent ``ckv`` and the shared rope key ``kr``.  It
  takes ``ctx.get('decode_mla', ...)``; the default,
  :func:`decode_mla_reference`, is the reference's math in torch ops (the
  reference has no kernel for it).  The MLA cache ignores
  ``kv_cache_bits``, as the reference's does.  On 'model' shards both
  compute on the rank's heads (:func:`mla_tp_forward`,
  :func:`mla_tp_decode`; stages :func:`mla_in`, :func:`mla_mix`,
  :func:`mla_q`, :func:`mla_step_out`).

Sequence-sharded decode.  On one device ``meta['slots']`` is
``arange(Sc)`` and ``meta['total']`` equals ``Sc``, so the ring slot is
``cur % Sc`` (the GQA and the MLA caches alike).  The reference's
``axis_names`` (the sequence axes of its shard_map) become ``groups``: the
process groups of those axes, as ``launch/serving.py``'s
``make_decode_ctx`` passes them to :func:`decode_attn_reference` and
:func:`decode_mla_reference`.  Each rank then holds a chunk of the cache
(``make_cache_meta(n, local_offset, local_len)``: ``slots`` carries the
global slot indices it owns, and the ctx passes the chunk's first slot
and the ring's size as Python ints, ``chunk``); the new token is written
only by the rank that owns slot ``cur % total``, and the partial softmax
statistics merge
as in the reference: an all-reduce max of ``m``, then sums of ``l`` and
``o``, over each group in turn.  With no groups both are the
single-device functions.  ``cur`` is the position as a Python int (a
0-dim tensor is read with ``int()``): the host picks the slot.

In place.  JAX returns a new cache from every write; the port writes the
cache's tensors in place and returns the same dict (the single-device form
of the reference's donated cache buffer).  A caller that needs the cache
before a step clones it.

Cross-attention (whisper's decoder) attends to the encoder output with
:func:`chunked_attention` in prefill and in :func:`gqa_cross_decode`, as
the reference does: its k/v are projected from the encoder output on
every call and never cached.  A local layer's cache holds
``min(window, max_len)`` slots, written as a ring: a prefill longer than
the window keeps its last ``window`` positions (:func:`prefill_cache_write`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import recip32
from repro_torch.models.layers import (dense, he_init, init_dense,
                                       init_norm, rms_norm, rope, row_bias,
                                       row_part, softcap)
from repro_torch.models.tp import (copy_in, current_tp, gather_cols,
                                   rank_cols, reduce_out, seq_chunk)

NEG_INF = -1e30


# ----------------------------------------------------------------- params


def init_attention(gen, cfg, dtype=torch.float32, device='cpu', stack=()):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device, stack=stack)
    return {'wq': init_dense(gen, d, H * hd, **kw),
            'wk': init_dense(gen, d, K * hd, **kw),
            'wv': init_dense(gen, d, K * hd, **kw),
            'wo': init_dense(gen, H * hd, d, dtype=dtype, device=device,
                             stack=stack)}


def init_mla(gen, cfg, dtype=torch.float32, device='cpu', stack=()):
    d, H = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dr, dn, dv = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        'wq_a': init_dense(gen, d, r_q, stack=stack, **kw),
        'q_norm': init_norm(r_q, stack=stack, **kw),
        'wq_b': init_dense(gen, r_q, H * (dr + dn), stack=stack, **kw),
        'wkv_a': init_dense(gen, d, r_kv + dr, stack=stack, **kw),
        'kv_norm': init_norm(r_kv, stack=stack, **kw),
        # the up-projections from the latent, per head, so that decode can
        # absorb them into q and the output
        'wk_b': he_init(gen, (*stack, r_kv, H, dn), r_kv, **kw),
        'wv_b': he_init(gen, (*stack, r_kv, H, dv), r_kv, **kw),
        'wo': init_dense(gen, H * dv, d, stack=stack, **kw)}


# ------------------------------------------- chunked attention (prefill)


def chunked_attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                      attn_softcap=0.0, chunk=512):
    """Online-softmax attention over KV chunks.

    q: (B,S,H,Dq)  k: (B,T,K,Dq)  v: (B,T,K,Dv)  q_pos: (S,)  k_pos: (T,)
    Returns (B,S,H,Dv).  GQA via H = K*g.  k_pos == -1 marks padding.
    With no gradient to take, a chunk's scores are masked, shifted and
    exponentiated in place (the same numbers, one (B,S,H,chunk) fp32
    tensor live where there would be four)."""
    inplace = not torch.is_grad_enabled()
    B, S, H, Dq = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // K
    chunk = min(chunk, T)
    if T % chunk:
        pad = chunk - T % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        T += pad
    qg = q.reshape(B, S, K, g, Dq) * (Dq ** -0.5)
    m = torch.full((B, S, K, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, K, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, g, Dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pc = k_pos[c0:c0 + chunk]
        # preferred_element_type=f32: bf16 products are exact in fp32
        logits = torch.einsum('bskgd,bckd->bskgc', qg.to(torch.float32),
                              kc.to(qg.dtype).to(torch.float32))
        if attn_softcap:
            logits = (logits.div_(attn_softcap).tanh_().mul_(attn_softcap)
                      if inplace else softcap(logits, attn_softcap))
        valid = (pc[None, :] >= 0).expand(S, -1)
        if causal:
            valid = valid & (pc[None, :] <= q_pos[:, None])
        if window:
            valid = valid & (pc[None, :] > q_pos[:, None] - window)
        if inplace:
            logits.masked_fill_(~valid[None, :, None, None, :], NEG_INF)
        else:
            logits = torch.where(valid[None, :, None, None, :], logits,
                                 torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = (logits.sub_(m_new[..., None]).exp_() if inplace
             else torch.exp(logits - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            'bskgc,bckv->bskgv', p.to(vc.dtype), vc).to(acc.dtype)
        m = m_new
        del logits, p        # before the next chunk's scores are made
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, S, H, Dv).to(q.dtype)


# ------------------------------------------------------- decode attention


def _owned_slot(n_local: int, cur: int, chunk=None):
    """The local index of ring slot ``cur % total`` in this cache chunk, or
    None where another rank owns it.  ``chunk``: (the chunk's first ring
    slot, the ring's slots), Python ints, so the host reads nothing off
    the device; None where the cache is whole, and the slot is ``cur %
    n_local``."""
    if chunk is None:
        return cur % n_local
    offset, total = chunk
    slot = cur % total - offset
    return slot if 0 <= slot < n_local else None


def _merge(m, l_fn, groups):
    """The reference's softmax merge over the sequence groups: ``m`` maxed
    over every group (in place), floored at -1e29; then ``l_fn(m)`` gives
    the local (l, o), each summed over every group."""
    import torch.distributed as dist
    from repro_torch.models.actsharding import note_group
    for g in groups:
        note_group('all_reduce', m, g)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    l, o = l_fn(torch.clamp_min(m, -1e29))
    for g in groups:
        note_group('all_reduce', l, g)
        dist.all_reduce(l, group=g)
        note_group('all_reduce', o, g)
        dist.all_reduce(o, group=g)
    return l, o


def _ring_write(cache, new_k, new_v, cur: int, chunk=None):
    """Write the new token's k/v (int8 codes and scales for an int8 cache)
    into its ring slot and record its position, in place (on the rank
    that owns the slot)."""
    slot = _owned_slot(cache['k'].shape[1], cur, chunk)
    if slot is None:
        return
    if 'k_s' in cache:
        nk_q, nk_s = kv_quantize(new_k)
        nv_q, nv_s = kv_quantize(new_v)
        cache['k'][:, slot] = nk_q
        cache['v'][:, slot] = nv_q
        cache['k_s'][:, slot] = nk_s
        cache['v_s'][:, slot] = nv_s
    else:
        cache['k'][:, slot] = new_k.to(cache['k'].dtype)
        cache['v'][:, slot] = new_v.to(cache['v'].dtype)
    cache['meta']['pos'][slot] = cur


def _valid(positions, cur: int, window: int):
    valid = (positions >= 0) & (positions <= cur)
    if window:
        valid = valid & (positions > cur - window)
    return valid


def decode_attn_kernel(q, new_k, new_v, cache, cur, *, window=0,
                       attn_softcap=0.0):
    """The port's decode attention: ring write, then the decode kernel over
    the whole cache, with the attention softcap when ``attn_softcap`` is
    set.  q: (B,H,D); new_k/new_v: (B,K,D); cache: {'k','v', 'meta'[,
    'k_s','v_s']} with k (B,Sc,K,D).  Returns (out (B,H,D), cache), the
    cache written in place."""
    cur = int(cur)
    _ring_write(cache, new_k, new_v, cur)
    valid = _valid(cache['meta']['pos'], cur, window)
    if 'k_s' in cache:
        out = ops.decode_attention_int8(q, cache['k'], cache['v'],
                                        cache['k_s'], cache['v_s'], valid,
                                        attn_softcap=attn_softcap)
    else:
        out = ops.decode_attention(q, cache['k'], cache['v'], valid,
                                   attn_softcap=attn_softcap)
    return out, cache


def decode_attn_reference(q, new_k, new_v, cache, cur, *, window=0,
                          attn_softcap=0.0, groups=(), chunk=None):
    """The reference's decode math in plain torch: ring write, then
    attention over the dequantized cache with q scaled in its own dtype
    and the softmax max floored at -1e29 (a row with no valid slot gives
    zeros).  ``groups``: the sequence axes' process groups when ``cache``
    is this rank's chunk (the merge then spans them), and ``chunk`` its
    place in the ring (:func:`_owned_slot`).  Writes the cache in place;
    returns (out, cache)."""
    cur = int(cur)
    _ring_write(cache, new_k, new_v, cur, chunk)
    B, Sc, K, Dq = cache['k'].shape
    H = q.shape[1]
    g = H // K
    Dv = cache['v'].shape[-1]
    if 'k_s' in cache:
        k_eff = kv_dequantize(cache['k'], cache['k_s'], q.dtype)
        v_eff = kv_dequantize(cache['v'], cache['v_s'], q.dtype)
    else:
        k_eff, v_eff = cache['k'], cache['v']
    qg = q.reshape(B, K, g, Dq) * (Dq ** -0.5)
    logits = torch.einsum('bkgd,bskd->bkgs', qg.to(torch.float32),
                          k_eff.to(qg.dtype).to(torch.float32))
    if attn_softcap:
        logits = softcap(logits, attn_softcap)
    valid = _valid(cache['meta']['pos'], cur, window)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))

    def partials(m):
        p = torch.exp(logits - m[..., None])
        return torch.sum(p, dim=-1), torch.einsum(
            'bkgs,bskv->bkgv', p.to(v_eff.dtype), v_eff).to(torch.float32)
    l, o = _merge(torch.amax(logits, dim=-1), partials, groups)
    out = (o / torch.clamp_min(l, 1e-30)[..., None]).reshape(B, H, Dv)
    return out.to(q.dtype), cache


# ---------------------------------------------------------- GQA block apply


def gqa_forward(p, x, positions, cfg, *, kind, quant=(0, 0), kv=None,
                full_kv=True):
    """Train/prefill attention.  Returns (out, (k, v)) for the cache fill.
    ``kind`` 'encoder' attends without the causal mask; ``kv`` = (enc,
    enc_pos) makes it cross-attention over the encoder output (no rope on
    q or k, no causal mask).  On 'model' shards (``wo`` marked ``'row'``)
    each rank's part (:func:`gqa_partial`) is summed over 'model'; (k, v)
    then hold every kv head only with ``full_kv``."""
    if p['wo'].get('tp') == 'row':
        tp = current_tp()
        y, kvs = gqa_partial(p, x, positions, cfg, kind=kind, tp=tp, kv=kv,
                             full_kv=full_kv)
        return row_bias(p['wo'], reduce_out(y, tp)), kvs
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p['wq'], x, quant=quant).reshape(B, S, H, hd)
    if kv is None:
        k = dense(p['wk'], x, quant=quant).reshape(B, S, K, hd)
        v = dense(p['wv'], x, quant=quant).reshape(B, S, K, hd)
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
        k_pos, causal = positions, kind != 'encoder'
    else:
        enc, enc_pos = kv
        T = enc.shape[1]
        k = dense(p['wk'], enc, quant=quant).reshape(B, T, K, hd)
        v = dense(p['wv'], enc, quant=quant).reshape(B, T, K, hd)
        k_pos, causal = enc_pos, False
    window = cfg.window if kind == 'local' else 0
    out = chunked_attention(q, k, v, positions, k_pos, causal=causal,
                            window=window, attn_softcap=cfg.attn_softcap)
    out = dense(p['wo'], out.reshape(B, S, H * hd), quant=quant)
    return out, (k, v)


def _kv_for(k, v, klo, qlo, Hl, g):
    """The kv heads that query heads ``qlo .. qlo + Hl`` read, from k/v
    holding heads ``klo ..``: a slice where the query heads share them
    evenly, else one kv head per query head."""
    need = [(qlo + j) // g for j in range(Hl)]
    lo, n = need[0], need[-1] - need[0] + 1
    if Hl % n == 0 and need == [lo + j // (Hl // n) for j in range(Hl)]:
        return k[:, :, lo - klo:lo - klo + n], v[:, :, lo - klo:lo - klo + n]
    idx = torch.tensor([h - klo for h in need], device=k.device)
    return k[:, :, idx], v[:, :, idx]


def gqa_partial(p, x, positions, cfg, *, kind, tp, kv=None, full_kv=False):
    """This rank's part of the attention on its 'model' shards, before the
    sum over 'model' (``wo``'s bias, if any, is added once after it).
    Returns (part, (k, v)).

    ``wq`` split by columns (marked ``'col'``) gives this rank whole query
    heads ``rank * H/m ..``; ``wk``/``wv`` split so give it kv heads
    ``rank * K/m ..`` where m divides K, else a shard that cuts a kv head,
    whose columns are gathered over 'model' (the layer's k and v whole on
    every rank; each rank reads the heads its queries need), and whole
    ``wk``/``wv`` give k/v whole.  A whole ``wq`` (``cfg.shard_heads``
    off) gives every head on every rank, and the rank multiplies its rows
    of ``wo`` by its chunk of the heads' output.  (k, v) hold this rank's
    kv heads, or every kv head with ``full_kv`` (gathered where split)."""
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    m, r = tp.size, tp.rank
    xs = copy_in(x, tp)
    if p['wq'].get('tp') == 'col':
        Hl, qlo = H // m, r * (H // m)
        q = dense(p['wq'], xs).reshape(B, S, Hl, hd)
    else:
        Hl, qlo = H, 0
        q = dense(p['wq'], x).reshape(B, S, H, hd)
    src, k_pos, causal = ((x, positions, kind != 'encoder') if kv is None
                          else (kv[0], kv[1], False))
    srcs = xs if kv is None else copy_in(src, tp)
    T = src.shape[1]

    def proj(name):
        w = p[name]
        if w.get('tp') != 'col':
            y = dense(w, src)
            # whole on every rank; each reads its query heads' kv heads
            return (copy_in(y, tp) if Hl < H else y).reshape(B, T, K, hd), 0
        y = dense(w, srcs)
        if K % m == 0:
            return y.reshape(B, T, K // m, hd), r * (K // m)
        return gather_cols(y, tp).reshape(B, T, K, hd), 0

    (k, klo), (v, _) = proj('wk'), proj('wv')
    if kv is None:
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    ks, vs = _kv_for(k, v, klo, qlo, Hl, H // K)
    window = cfg.window if kind == 'local' else 0
    out = chunked_attention(q, ks, vs, positions, k_pos, causal=causal,
                            window=window, attn_softcap=cfg.attn_softcap)
    out = out.reshape(B, S, Hl * hd)
    if Hl == H:
        out = rank_cols(out, tp)
    if full_kv and k.shape[2] < K:
        k, v = (gather_cols(t.reshape(B, T, -1), tp).reshape(B, T, K, hd)
                for t in (k, v))
    return row_part(p['wo'], out), (k, v)


def _whole(p, x, quant):
    """``dense(p, x)``, its columns gathered over 'model' where ``p`` is a
    column shard."""
    y = dense(p, x, quant=quant)
    return gather_cols(y, current_tp()) if p.get('tp') == 'col' else y


def _out_proj(p, o, quant):
    """``o`` (every head) through ``wo``; on a row shard, this rank's rows
    times its chunk of ``o``, summed over 'model'."""
    if p.get('tp') != 'row':
        return dense(p, o, quant=quant)
    tp = current_tp()
    return row_bias(p, reduce_out(row_part(p, rank_cols(o, tp)), tp))


def gqa_decode(p, x, cur, cfg, *, kind, cache, ctx, quant=(0, 0)):
    """One-token decode.  x: (B, d).  Returns (out, cache).  On 'model'
    shards q, k and v are gathered to every head (the cache is
    sequence-sharded over 'model', every head on every rank) and ``wo``
    runs on this rank's rows."""
    B, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos1 = torch.full((1,), int(cur), dtype=torch.int32, device=x.device)
    q = _whole(p['wq'], x[:, None], quant).reshape(B, 1, H, hd)
    nk = _whole(p['wk'], x[:, None], quant).reshape(B, 1, K, hd)
    nv = _whole(p['wv'], x[:, None], quant).reshape(B, 1, K, hd)
    q = rope(q, pos1, theta=cfg.rope_theta)[:, 0]
    nk = rope(nk, pos1, theta=cfg.rope_theta)[:, 0]
    nv = nv[:, 0]
    window = cfg.window if kind == 'local' else 0
    fn = ctx.get('decode_attn', decode_attn_kernel)
    out, cache = fn(q, nk, nv, cache, cur, window=window,
                    attn_softcap=cfg.attn_softcap)
    out = _out_proj(p['wo'], out.reshape(B, H * hd), quant)
    return out, cache


def gqa_cross_decode(p, x, enc, enc_pos, cfg, *, quant=(0, 0)):
    """Cross-attention of one decoder token against the whole encoder
    output: x (B, d), enc (B, T, d), enc_pos (T,).  Returns (B, d)."""
    B, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T = enc.shape[1]
    q = _whole(p['wq'], x, quant).reshape(B, 1, H, hd)
    k = _whole(p['wk'], enc, quant).reshape(B, T, K, hd)
    v = _whole(p['wv'], enc, quant).reshape(B, T, K, hd)
    out = chunked_attention(q, k, v, torch.zeros((1,), dtype=torch.int32,
                                                 device=x.device),
                            enc_pos, causal=False)
    return _out_proj(p['wo'], out.reshape(B, H * hd), quant)


# ---------------------------------------------------------- MLA block apply


def mla_forward(p, x, positions, cfg, *, quant=(0, 0), seq_split=False):
    """Train/prefill MLA.  Returns (out, (ckv, k_rope)) for the cache
    fill: the latent (B, S, kv_lora_rank) and the shared rope key
    (B, S, rope_head_dim).  On 'model' shards (``wo`` marked ``'row'``)
    :func:`mla_tp_forward` (``seq_split`` its argument)."""
    if p['wo'].get('tp') == 'row':
        return mla_tp_forward(p, x, positions, cfg, current_tp(),
                              seq_split=seq_split)
    B, S, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dr, dn, dv = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    cq = rms_norm(p['q_norm'], dense(p['wq_a'], x, quant=quant), cfg.norm_eps)
    q = dense(p['wq_b'], cq, quant=quant).reshape(B, S, H, dr + dn)
    q_rope = rope(q[..., :dr], positions, theta=cfg.rope_theta)
    kv_a = dense(p['wkv_a'], x, quant=quant)
    ckv = rms_norm(p['kv_norm'], kv_a[..., :r], cfg.norm_eps)
    k_rope = rope(kv_a[..., None, r:], positions,
                  theta=cfg.rope_theta)[..., 0, :]                # (B,S,dr)
    k_nope = torch.einsum('bsr,rhn->bshn', ckv, p['wk_b'].to(ckv.dtype))
    v = torch.einsum('bsr,rhv->bshv', ckv, p['wv_b'].to(ckv.dtype))
    k = torch.cat([k_rope[:, :, None].expand(B, S, H, dr), k_nope], dim=-1)
    q_full = torch.cat([q_rope, q[..., dr:]], dim=-1)
    out = chunked_attention(q_full, k, v, positions, positions, causal=True)
    out = dense(p['wo'], out.reshape(B, S, H * dv), quant=quant)
    return out, (ckv, k_rope)


def decode_mla_reference(q_nope_lat, q_rope, new_ckv, new_kr, cache, cur,
                         *, groups=(), chunk=None):
    """Absorbed-MLA decode, the reference's math in torch ops: the latent
    ``new_ckv`` (B, r) and rope key ``new_kr`` (B, dr) written into their
    ring slot in place, then attention in the latent space in fp32 with
    q_nope already absorbed through wk_b (``q_nope_lat`` (B, H, r)) and
    both halves of q pre-scaled by the caller; the softmax max is floored
    at -1e29.  ``groups`` and ``chunk`` as in
    :func:`decode_attn_reference`.  Returns
    (out_latent (B, H, r) fp32, cache); the caller up-projects through
    wv_b."""
    cur = int(cur)
    slot = _owned_slot(cache['ckv'].shape[1], cur, chunk)
    if slot is not None:
        cache['ckv'][:, slot] = new_ckv.to(cache['ckv'].dtype)
        cache['kr'][:, slot] = new_kr.to(cache['kr'].dtype)
        cache['meta']['pos'][slot] = cur
    positions = cache['meta']['pos']
    ckv = cache['ckv'].to(torch.float32)
    logits = (torch.einsum('bhr,bsr->bhs', q_nope_lat.to(torch.float32), ckv)
              + torch.einsum('bhd,bsd->bhs', q_rope.to(torch.float32),
                             cache['kr'].to(torch.float32)))
    valid = _valid(positions, cur, 0)
    logits = torch.where(valid[None, None, :], logits,
                         torch.full((), NEG_INF, device=logits.device))

    def partials(m):
        pr = torch.exp(logits - m[..., None])
        return torch.sum(pr, dim=-1), torch.einsum('bhs,bsr->bhr', pr, ckv)
    l, o = _merge(torch.amax(logits, dim=-1), partials, groups)
    return o / torch.clamp_min(l, 1e-30)[..., None], cache


def mla_decode(p, x, cur, cfg, *, cache, ctx, quant=(0, 0)):
    """One-token MLA decode.  x: (B, d).  Returns (out, cache).  q's rope
    half takes the reference's broadcast: ``rope(q[None, ..., :dr])``
    puts the batch on the sequence axis at the one position ``cur``.  On
    'model' shards :func:`mla_tp_decode`."""
    if p['wo'].get('tp') == 'row':
        return mla_tp_decode(p, x, cur, cfg, current_tp(), cache=cache,
                             ctx=ctx)
    B, _ = x.shape
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dr, dn, dv = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    pos1 = torch.full((1,), int(cur), dtype=torch.int32, device=x.device)
    cq = rms_norm(p['q_norm'], dense(p['wq_a'], x, quant=quant), cfg.norm_eps)
    q = dense(p['wq_b'], cq, quant=quant).reshape(B, H, dr + dn)
    scale = (dr + dn) ** -0.5
    q_rope = rope(q[None, ..., :dr], pos1, theta=cfg.rope_theta)[0] * scale
    q_nope = q[..., dr:] * scale
    # absorb through wk_b: (B,H,dn) x (r,H,dn) -> (B,H,r)
    q_lat = torch.einsum('bhn,rhn->bhr', q_nope, p['wk_b'].to(q_nope.dtype))
    kv_a = dense(p['wkv_a'], x, quant=quant)
    new_ckv = rms_norm(p['kv_norm'], kv_a[..., :r], cfg.norm_eps)
    new_kr = rope(kv_a[:, None, None, r:], pos1,
                  theta=cfg.rope_theta)[:, 0, 0]
    fn = ctx.get('decode_mla', decode_mla_reference)
    out_lat, cache = fn(q_lat, q_rope, new_ckv, new_kr, cache, cur)
    out = torch.einsum('bhr,rhv->bhv', out_lat.to(x.dtype),
                       p['wv_b'].to(x.dtype))
    out = dense(p['wo'], out.reshape(B, H * dv), quant=quant)
    return out, cache


# ---------------------------------------------- MLA on its 'model' shards
#
# The sharding rules cut ``wq_b``'s columns (whole heads, rope and nope
# halves together), ``wk_b``/``wv_b`` on their heads dim and ``wo``'s
# rows over 'model', and leave ``wq_a``, ``wkv_a`` and the two norms
# whole.  So every rank computes the latents ``cq``, ``ckv`` and the rope
# key whole (:func:`mla_in`, as GSPMD does with replicated weights), each
# entering its heads through ``copy_in`` (their gradients summed over
# 'model').  In a layer whose MoE block cuts the sequence over 'model'
# (``moe.splits_sequence``) GSPMD carries that cut back into the latent
# projections: each rank then computes them on its chunk of the tokens,
# all-gathered along the sequence (``seq_split``; their weights'
# gradients summed over 'model').  The rank attends with its ``H / m``
# heads (:func:`mla_mix`) and multiplies its rows of ``wo``
# (``layers.row_part``), summed over 'model' once.  The latent cache
# has no heads: it stays whole, cut by sequence only.  A decode absorbs q through the rank's ``wk_b`` heads
# (:func:`mla_q`), gathers it to every head (each rank holds a sequence
# chunk of the cache for every head), and up-projects its heads of the
# latent output through its ``wv_b`` (:func:`mla_step_out`).  The stages
# are apart so that one process can play every rank.


def mla_in(p, x, positions, cfg):
    """The latents every rank computes whole: (``cq`` (B, S, q_lora_rank),
    ``ckv`` (B, S, kv_lora_rank), the rope key (B, S, rope_head_dim))."""
    r = cfg.kv_lora_rank
    cq = rms_norm(p['q_norm'], dense(p['wq_a'], x), cfg.norm_eps)
    kv_a = dense(p['wkv_a'], x)
    ckv = rms_norm(p['kv_norm'], kv_a[..., :r], cfg.norm_eps)
    k_rope = rope(kv_a[..., None, r:], positions,
                  theta=cfg.rope_theta)[..., 0, :]
    return cq, ckv, k_rope


def mla_mix(p, cq, ckv, k_rope, positions, cfg):
    """This rank's heads' attention (B, S, H/m * v_head_dim) from the
    whole latents: q from its ``wq_b`` columns, k_nope and v through its
    ``wk_b``/``wv_b`` heads."""
    B, S, _ = cq.shape
    dr, dn = cfg.rope_head_dim, cfg.nope_head_dim
    Hl = p['wk_b'].shape[1]
    q = dense(p['wq_b'], cq).reshape(B, S, Hl, dr + dn)
    q_rope = rope(q[..., :dr], positions, theta=cfg.rope_theta)
    k_nope = torch.einsum('bsr,rhn->bshn', ckv, p['wk_b'].to(ckv.dtype))
    v = torch.einsum('bsr,rhv->bshv', ckv, p['wv_b'].to(ckv.dtype))
    k = torch.cat([k_rope[:, :, None].expand(B, S, Hl, dr), k_nope], dim=-1)
    q_full = torch.cat([q_rope, q[..., dr:]], dim=-1)
    out = chunked_attention(q_full, k, v, positions, positions, causal=True)
    return out.reshape(B, S, Hl * v.shape[-1])


def mla_tp_forward(p, x, positions, cfg, tp, *, seq_split=False):
    """:func:`mla_forward` on this rank's 'model' shards (the comment
    above); the latent and the rope key come out whole.  ``seq_split``:
    the latent projections on this rank's chunk of the tokens."""
    if seq_split and x.shape[1] % tp.size == 0:
        n = x.shape[1] // tp.size
        lat = {k: {name: copy_in(t, tp) for name, t in p[k].items()}
               for k in ('wq_a', 'q_norm', 'wkv_a', 'kv_norm')}
        parts = mla_in(lat, seq_chunk(x, tp),
                       positions[tp.rank * n:(tp.rank + 1) * n], cfg)
        cq, ckv, k_rope = lats = tuple(gather_cols(t, tp, dim=1)
                                       for t in parts)
    else:
        cq, ckv, k_rope = mla_in(p, x, positions, cfg)
        lats = (copy_in(t, tp) for t in (cq, ckv, k_rope))
    o = mla_mix(p, *lats, positions, cfg)
    out = row_bias(p['wo'], reduce_out(row_part(p['wo'], o), tp))
    return out, (ckv, k_rope)


def mla_q(p, x, cur, cfg):
    """This rank's heads of a decode step's absorbed query, pre-scaled:
    (q_lat (B, H/m, kv_lora_rank), q_rope (B, H/m, rope_head_dim)), as
    :func:`mla_decode` makes them for every head."""
    B, _ = x.shape
    dr, dn = cfg.rope_head_dim, cfg.nope_head_dim
    Hl = p['wk_b'].shape[1]
    pos1 = torch.full((1,), int(cur), dtype=torch.int32, device=x.device)
    cq = rms_norm(p['q_norm'], dense(p['wq_a'], x), cfg.norm_eps)
    q = dense(p['wq_b'], cq).reshape(B, Hl, dr + dn)
    scale = (dr + dn) ** -0.5
    q_rope = rope(q[None, ..., :dr], pos1, theta=cfg.rope_theta)[0] * scale
    q_nope = q[..., dr:] * scale
    q_lat = torch.einsum('bhn,rhn->bhr', q_nope, p['wk_b'].to(q_nope.dtype))
    return q_lat, q_rope


def mla_kv_step(p, x, cur, cfg):
    """A decode step's new latent (B, kv_lora_rank) and rope key (B,
    rope_head_dim), whole on every rank."""
    r = cfg.kv_lora_rank
    pos1 = torch.full((1,), int(cur), dtype=torch.int32, device=x.device)
    kv_a = dense(p['wkv_a'], x)
    new_ckv = rms_norm(p['kv_norm'], kv_a[..., :r], cfg.norm_eps)
    new_kr = rope(kv_a[:, None, None, r:], pos1,
                  theta=cfg.rope_theta)[:, 0, 0]
    return new_ckv, new_kr


def mla_step_out(p, out_lat, dtype):
    """This rank's part of ``wo`` from its heads of the latent output
    ``out_lat`` (B, H/m, kv_lora_rank), up-projected through its
    ``wv_b``."""
    B = out_lat.shape[0]
    o = torch.einsum('bhr,rhv->bhv', out_lat.to(dtype), p['wv_b'].to(dtype))
    return row_part(p['wo'], o.reshape(B, -1))


def _heads_gathered(t, tp):
    """(B, H/m, n) -> (B, H, n): every rank's heads, in rank order."""
    B, hl, n = t.shape
    return gather_cols(t.reshape(B, hl * n), tp).reshape(B, -1, n)


def _rank_heads(t, tp):
    """(B, H, n) -> (B, H/m, n): this rank's heads."""
    B, h, n = t.shape
    return rank_cols(t.reshape(B, h * n), tp).reshape(B, -1, n)


def mla_tp_decode(p, x, cur, cfg, tp, *, cache, ctx):
    """:func:`mla_decode` on this rank's 'model' shards: q gathered to
    every head, the attention over this rank's chunk of the latent cache
    through ``ctx['decode_mla']``, then this rank's heads up-projected and
    ``wo`` by rows, summed over 'model'."""
    q_lat, q_rope = mla_q(p, x, cur, cfg)
    new_ckv, new_kr = mla_kv_step(p, x, cur, cfg)
    fn = ctx.get('decode_mla', decode_mla_reference)
    out_lat, cache = fn(_heads_gathered(q_lat, tp),
                        _heads_gathered(q_rope, tp), new_ckv, new_kr, cache,
                        cur)
    part = mla_step_out(p, _rank_heads(out_lat, tp), x.dtype)
    return row_bias(p['wo'], reduce_out(part, tp)), cache


# --------------------------------------------------------- cache builders


def make_cache_meta(n_slots: int, local_offset: int = 0,
                    local_len: int | None = None, device='cpu'):
    """A ring's meta: the global slot indices this cache (chunk) holds,
    each slot's position (-1 = empty) and the ring's total slots."""
    ll = n_slots if local_len is None else local_len
    return {'slots': local_offset + torch.arange(ll, dtype=torch.int32,
                                                 device=device),
            'pos': torch.full((ll,), -1, dtype=torch.int32, device=device),
            'total': torch.tensor(n_slots, dtype=torch.int32, device=device)}


def kv_quantize(x, axis=-1):
    """int8-quantize along head_dim with per-(token, head) scales.

    The scale is ``max(amax, 1e-8) * fp32(1/127)``: the reference divides
    by 127.0 inside jit, where XLA folds the constant divisor into that
    reciprocal (its prefill and serve step both run jitted)."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=axis)
    s = torch.clamp_min(amax, 1e-8) * recip32(127.0)
    q = torch.clamp(torch.round(xf / s.unsqueeze(axis)), -128, 127)
    return q.to(torch.int8), s


def kv_dequantize(q, s, dtype):
    return (q.to(torch.float32) * s[..., None]).to(dtype)


def ring_slots(cfg, kind, max_len) -> int:
    """The slots of a ``kind`` layer's cache ring: ``max_len``, or the
    window for a local layer's."""
    return min(cfg.window, max_len) if kind == 'local' else max_len


def _chunk_of(n, chunk):
    """(first slot, slots) of this rank's chunk of a ring of ``n`` slots
    under ``chunk`` (a function of ``n``, None for the whole ring)."""
    c = chunk(n) if chunk is not None else None
    return (0, n) if c is None else c


def init_attn_cache(cfg, batch, kind, max_len, dtype, device='cpu',
                    chunk=None):
    """A fresh cache ring; with ``chunk`` (``ring slots -> (first slot,
    slots)`` or None, Python ints) only this rank's chunk of it."""
    n = ring_slots(cfg, kind, max_len)
    off, nl = _chunk_of(n, chunk)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    c = {'meta': make_cache_meta(n, off, nl, device=device)}
    if cfg.kv_cache_bits == 8:
        # int8 KV cache with per-(token, head) scales: halves the cache
        # bytes every decode step reads
        c['k'] = torch.zeros((batch, nl, K, hd), dtype=torch.int8,
                             device=device)
        c['v'] = torch.zeros_like(c['k'])
        # the rules keep the scales whole: only the codes are cut
        c['k_s'] = torch.zeros((batch, n, K), dtype=torch.float32,
                               device=device)
        c['v_s'] = torch.zeros_like(c['k_s'])
    else:
        c['k'] = torch.zeros((batch, nl, K, hd), dtype=dtype, device=device)
        c['v'] = torch.zeros_like(c['k'])
    return c


def chunk_rows(S: int, chunk, device):
    """(prompt positions, local slots) as int64 tensors: the positions
    of a prompt ``0 .. S - 1`` that a ring's chunk ``chunk`` = (first
    slot, slots, ring slots) keeps after a prefill (the last ``min(S,
    ring)`` of them, position ``p`` in slot ``p % ring``) and the chunk's
    slots they go to, from Python ints alone."""
    off, n_local, total = chunk
    src, dst = [], []
    for i in range(n_local):
        s = off + i
        if s < S:
            src.append(s + total * ((S - 1 - s) // total))
            dst.append(i)
    return (torch.tensor(src, dtype=torch.int64, device=device),
            torch.tensor(dst, dtype=torch.int64, device=device))


def prefill_cache_write(cache, k, v, positions, chunk=None):
    """Write prefill k/v (B,S,K,D) into a fresh cache (ring-aware), in
    place; returns the cache.  ``chunk`` = (first slot, slots, ring
    slots): the cache's k/v and positions are that chunk of the ring (its
    int8 scales whole, as the rules keep them) and ``positions`` are
    ``0 .. S - 1`` (:func:`chunk_rows`)."""
    S = k.shape[1]
    Sc = cache['k'].shape[1] if chunk is None else chunk[2]
    take = min(S, Sc)
    kt, vt = k[:, S - take:], v[:, S - take:]
    pt = positions[S - take:]
    slots = torch.remainder(pt, Sc).to(torch.int64)
    if 'k_s' in cache:
        kt, ks = kv_quantize(kt)
        vt, vs = kv_quantize(vt)
        cache['k_s'].index_copy_(1, slots, ks)
        cache['v_s'].index_copy_(1, slots, vs)
    if chunk is not None:
        src, slots = chunk_rows(S, chunk, k.device)
        src = src - (S - take)
        kt, vt = kt.index_select(1, src), vt.index_select(1, src)
        pt = pt.index_select(0, src)
    cache['k'].index_copy_(1, slots, kt.to(cache['k'].dtype))
    cache['v'].index_copy_(1, slots, vt.to(cache['v'].dtype))
    cache['meta']['pos'].index_copy_(0, slots, pt.to(torch.int32))
    return cache


def init_mla_cache(cfg, batch, max_len, dtype, device='cpu', chunk=None):
    """The MLA cache: the latent and the rope key of every position
    (``kv_cache_bits`` does not apply, as in the reference); with
    ``chunk`` this rank's chunk (:func:`init_attn_cache`)."""
    off, nl = _chunk_of(max_len, chunk)
    return {'ckv': torch.zeros((batch, nl, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            'kr': torch.zeros((batch, nl, cfg.rope_head_dim),
                              dtype=dtype, device=device),
            'meta': make_cache_meta(max_len, off, nl, device=device)}


def prefill_mla_cache_write(cache, ckv, kr, positions, chunk=None):
    """Write prefill latents (B,S,r) and rope keys (B,S,dr) into a fresh
    MLA cache, in place; returns the cache.  ``chunk`` as
    :func:`prefill_cache_write`'s."""
    if chunk is not None:
        src, slots = chunk_rows(ckv.shape[1], chunk, ckv.device)
        ckv, kr = ckv.index_select(1, src), kr.index_select(1, src)
        positions = positions.index_select(0, src)
    else:
        slots = torch.remainder(positions,
                                cache['ckv'].shape[1]).to(torch.int64)
    cache['ckv'].index_copy_(1, slots, ckv.to(cache['ckv'].dtype))
    cache['kr'].index_copy_(1, slots, kr.to(cache['kr'].dtype))
    cache['meta']['pos'].index_copy_(0, slots, positions.to(torch.int32))
    return cache
