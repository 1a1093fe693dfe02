"""Recurrent blocks of the LM side: RG-LRU (recurrentgemma/Griffin) and
Mamba-2's SSD, in PyTorch.

The reference's ``models/recurrent.py``.  Prefill runs the linear
recurrence ``h_t = a_t h_{t-1} + b_t`` over the sequence with
:func:`linear_scan`, in torch ops, the combines of the reference's
``jax.lax.associative_scan`` in its order, each multiply-add fused as
XLA fuses it (``torch.addcmul``), so that the two round alike.  SSD
is the chunked state-space-duality form: a quadratic intra-chunk term and
an inter-chunk recurrence over the chunks' end states, which uses the same
scan.  The reference has no Pallas kernel for either: both run in torch
ops, as they run in XLA ops there.

Decode carries O(1) state and writes it in place, as the attention caches
are written (``models/attention.py``): ``{'h', 'conv'}``, ``h`` in fp32
((B, W) for RG-LRU, (B, heads, headdim, N) for SSD) and ``conv`` the
causal conv's last k - 1 inputs in the model's dtype.

The dtypes are the reference's: ``lam`` is in the model's dtype, SSD's
``A_log``, ``D`` and ``dt_bias`` in fp32; the gates, the decays and the
states compute in fp32.  ``torch.einsum`` does not promote dtypes, so an
operand that JAX would promote (SSD's bf16 ``B``/``C`` beside fp32
decays) is cast to fp32 here; ``C . B`` stays in the operands' dtype, as
in JAX.  The reference's 3-operand einsums run as pairwise products (at
mamba2-2.7b's width, batch 8 and prompt 512, a (b, c, L, S, h) fp32 term
is 335 MB; a contraction through (b, c, L, S, h, p) would take 21 GB).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (causal_conv1d, conv1d_step, dense,
                                       init_conv1d, init_dense, rms_norm,
                                       row_bias, row_part, silu)
from repro_torch.models.tp import (copy_in, current_tp, gather_cols,
                                   rank_shard, reduce_out)


def linear_scan(a, b):
    """All states of ``h_t = a_t * h_{t-1} + b_t`` along axis 1, from
    ``h_{-1} = 0``: ``a`` broadcasts against ``b`` (the same number of
    axes).  The reference composes ``(al, bl), (ar, br) -> (al * ar,
    ar * bl + br)`` with ``jax.lax.associative_scan``; this is that
    scan's recursion (:func:`_scan_states`)."""
    return _scan_states(a, b)


def _scan_states(a, b):
    """``associative_scan``'s recursion on the states: adjacent pairs
    combined, the odd states from the scan of the pairs, each even state
    one combine from the odd state before it.  Only the states are
    returned, so a level's combined decays are never formed."""
    n = b.shape[1]
    if n < 2:
        return b
    ar, br = a[:, 1::2], b[:, 1::2]
    odd = _scan_states(a[:, 0:-1:2] * ar,
                       torch.addcmul(br, ar, b[:, 0:-1:2]))
    b2 = b[:, 2::2]
    even = torch.cat([b[:, :1], torch.addcmul(b2, a[:, 2::2],
                                              odd[:, :b2.shape[1]])], dim=1)
    if n % 2:
        return torch.cat([torch.stack([even[:, :-1], odd], dim=2)
                          .flatten(1, 2), even[:, -1:]], dim=1)
    return torch.stack([even, odd], dim=2).flatten(1, 2)


# ============================================================= RG-LRU

_RGLRU_C = 8.0


def init_rglru(gen, cfg, dtype=torch.float32, device='cpu', stack=()):
    d, w = cfg.d_model, cfg.rglru_width
    kw = dict(dtype=dtype, device=device, stack=stack)
    return {
        'wgate': init_dense(gen, d, w, **kw),
        'wx': init_dense(gen, d, w, **kw),
        'conv': init_conv1d(gen, w, cfg.rglru_conv, **kw),
        'w_r': init_dense(gen, w, w, **kw),
        'w_i': init_dense(gen, w, w, **kw),
        'lam': torch.full((*stack, w), 2.0, dtype=dtype, device=device),
        'wo': init_dense(gen, w, d, **kw),
    }


def _rglru_gates(p, u, quant, u_all=None):
    """(a, b) of the recurrence in fp32.  ``F.softplus`` returns x above
    20, where JAX adds log1p(exp(-x)); in fp32 that rounds to x.
    ``u_all``: the whole ``u`` where ``p`` is a rank's channels (``w_r``
    and ``w_i`` its columns, ``u`` its chunk)."""
    ui = u if u_all is None else u_all
    r = torch.sigmoid(dense(p['w_r'], ui, quant=quant).to(torch.float32))
    i = torch.sigmoid(dense(p['w_i'], ui, quant=quant).to(torch.float32))
    log_a = -_RGLRU_C * F.softplus(p['lam'].to(torch.float32)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * i * u.to(torch.float32)
    return a, b


def rglru_forward(p, x, cfg, *, quant=(0, 0), return_state=False):
    """x: (B, S, D) -> (B, S, D).  ``return_state``: also the decode state
    after the sequence, ``{'h': the last fp32 state (B, W), 'conv': the
    last k - 1 inputs of the conv}``.  On 'model' shards (``wo`` marked
    ``'row'``) :func:`rglru_tp_forward`."""
    if p['wo'].get('tp') == 'row':
        return rglru_tp_forward(p, x, cfg, current_tp(),
                                return_state=return_state)
    gate = F.gelu(dense(p['wgate'], x, quant=quant), approximate='tanh')
    u0 = dense(p['wx'], x, quant=quant)
    a, b = _rglru_gates(p, causal_conv1d(p['conv'], u0), quant)
    h = linear_scan(a, b)
    out = dense(p['wo'], h.to(x.dtype) * gate, quant=quant)
    if return_state:
        k = p['conv']['w'].shape[0]
        return out, {'h': h[:, -1], 'conv': u0[:, -(k - 1):, :]}
    return out


def rglru_decode(p, x, cache, cfg, *, quant=(0, 0)):
    """x: (B, D); cache = {'h': (B, W) fp32, 'conv': (B, k-1, W)}, written
    in place.  Returns (out (B, D), cache).  On 'model' shards
    :func:`rglru_tp_decode`."""
    if p['wo'].get('tp') == 'row':
        return rglru_tp_decode(p, x, cache, cfg, current_tp())
    gate = F.gelu(dense(p['wgate'], x, quant=quant), approximate='tanh')
    u0 = dense(p['wx'], x, quant=quant)
    u, conv_state = conv1d_step(p['conv'], u0, cache['conv'])
    a, b = _rglru_gates(p, u, quant)
    h = cache['h'].mul_(a).add_(b)
    cache['conv'].copy_(conv_state)
    out = dense(p['wo'], h.to(x.dtype) * gate, quant=quant)
    return out, cache


# -------------------------------------------- RG-LRU on its 'model' shards
#
# The sharding rules cut ``wgate``, ``wx``, ``w_r`` and ``w_i``'s columns,
# the conv's channels, ``lam`` and ``wo``'s rows over 'model', each
# contiguously: a rank holds the channels ``rank * W/m ..`` of all of
# them.  Its gate and conv input come from its columns
# (:func:`rglru_in`), the causal conv runs on its channels
# (``layers.causal_conv1d``, ``conv1d_step``: elementwise, no
# collective); ``w_r``/``w_i`` read every channel of the conv's output,
# so it is all-gathered once a layer (``gather_cols``: the backward keeps
# the rank's chunk of the summed gradient); the gates, ``lam`` and the
# scan run on its channels (:func:`rglru_scan`, in a decode
# :func:`rglru_step`) and ``wo`` is a row product (:func:`rglru_out`),
# summed over 'model' once.  The decode state is the rank's chunk of the
# channels.


def rglru_in(p, x, tp):
    """(gate, the conv's input) of this rank's channels: its columns of
    ``wgate`` (through the gelu) and of ``wx``."""
    xs = copy_in(x, tp)
    gate = F.gelu(dense(p['wgate'], xs), approximate='tanh')
    return gate, dense(p['wx'], xs)


def rglru_scan(p, u, u_all):
    """All fp32 states of this rank's channels from its chunk ``u`` of the
    conv's output and the whole ``u_all``."""
    a, b = _rglru_gates(p, u, (0, 0), u_all=u_all)
    return linear_scan(a, b)


def rglru_step(p, u, u_all, h_state):
    """One decode step of this rank's channels' state ``h_state``
    (updated in place and returned) from its chunk ``u`` of the conv's
    output and the whole ``u_all``."""
    a, b = _rglru_gates(p, u, (0, 0), u_all=u_all)
    return h_state.mul_(a).add_(b)


def rglru_out(p, h, gate):
    """This rank's part of ``wo`` (its rows, no bias) of its states times
    its gate."""
    return row_part(p['wo'], h.to(gate.dtype) * gate)


def rglru_tp_forward(p, x, cfg, tp, *, return_state=False):
    """:func:`rglru_forward` on this rank's 'model' shards (the comment
    above); the state is its channels'."""
    gate, u0 = rglru_in(p, x, tp)
    u = causal_conv1d(p['conv'], u0)
    h = rglru_scan(p, u, gather_cols(u, tp))
    out = row_bias(p['wo'], reduce_out(rglru_out(p, h, gate), tp))
    if return_state:
        k = p['conv']['w'].shape[0]
        return out, {'h': h[:, -1], 'conv': u0[:, -(k - 1):, :]}
    return out


def rglru_tp_decode(p, x, cache, cfg, tp):
    """:func:`rglru_decode` on this rank's 'model' shards: ``cache['h']``
    and ``cache['conv']`` its channels, written in place."""
    gate, u0 = rglru_in(p, x, tp)
    u, conv_state = conv1d_step(p['conv'], u0, cache['conv'])
    h = rglru_step(p, u, gather_cols(u, tp), cache['h'])
    cache['conv'].copy_(conv_state)
    out = row_bias(p['wo'], reduce_out(rglru_out(p, h, gate), tp))
    return out, cache


def init_rglru_cache(cfg, batch, dtype, device='cpu', tp=None):
    """The decode state; with ``tp`` (an RG-LRU block on 'model' shards)
    this rank's chunk of its channels, as the rules cut it."""
    w = cfg.rglru_width // (1 if tp is None else tp.size)
    return {'h': torch.zeros((batch, w), dtype=torch.float32, device=device),
            'conv': torch.zeros((batch, cfg.rglru_conv - 1, w), dtype=dtype,
                                device=device)}


# ======================================================== Mamba-2 (SSD)


def init_mamba2(gen, cfg, dtype=torch.float32, device='cpu', stack=()):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    h = d_in // hd
    kw = dict(dtype=dtype, device=device, stack=stack)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        'in_proj': init_dense(gen, d, 2 * d_in + 2 * n + h, **kw),
        'conv': init_conv1d(gen, d_in + 2 * n, cfg.ssm_conv, **kw),
        'A_log': torch.zeros((*stack, h), **f32),      # A = -exp(A_log) = -1
        'D': torch.ones((*stack, h), **f32),
        'dt_bias': torch.zeros((*stack, h), **f32),
        'norm': {'scale': torch.ones((*stack, d_in), dtype=dtype,
                                     device=device)},
        'out_proj': init_dense(gen, d_in, d, **kw),
    }


def _split_inproj(cfg, zxbcdt):
    """(z, xBC, dt) of the input projection: d_in, d_in + 2N and the heads
    along the last axis."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in + 2 * n,
                                zxbcdt.shape[-1] - 2 * d_in - 2 * n], dim=-1)


def ssd_chunked(x, a, B, C, chunk):
    """Chunked SSD scan (state-space duality, mamba2 minimal formulation).

    x: (b,l,h,p)  a: (b,l,h) log-decay per step  B,C: (b,l,n) (ngroups=1).
    Returns y (b,l,h,p) in x's dtype and the final state (b,h,p,n) fp32."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, l)
    assert l % L == 0, f'seq {l} not divisible by ssm chunk {L}'
    c = l // L
    f32 = torch.float32
    xr = x.reshape(b, c, L, h, p).to(f32)
    ar = a.reshape(b, c, L, h)
    Br = B.reshape(b, c, L, n)
    Cr = C.reshape(b, c, L, n)

    a_cs = torch.cumsum(ar, dim=2)                               # (b,c,L,h)
    # --- intra-chunk: (C . B) x the causal decays, then a product over s
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]        # (b,c,L,S,h)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    att = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                      torch.zeros((), dtype=f32, device=x.device))
    cb = torch.einsum('bcln,bcsn->bcls', Cr, Br)                 # (b,c,L,S)
    y_diag = torch.einsum('bclsh,bcshp->bclhp',
                          cb.to(f32)[..., None] * att, xr)

    # --- per-chunk end states
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)          # (b,c,L,h)
    states = torch.einsum('bcln,bclhp->bchpn', Br.to(f32),
                          decay_states[..., None] * xr)

    # --- inter-chunk linear recurrence over c; the state entering chunk i
    # is the state after chunk i - 1
    a_tot = torch.exp(a_cs[:, :, -1, :])                         # (b,c,h)
    s_run = linear_scan(a_tot[..., None, None], states)          # (b,c,h,p,n)
    s_prev = torch.cat([torch.zeros_like(s_run[:, :1]), s_run[:, :-1]],
                       dim=1)
    y_off = torch.einsum('bcln,bchpn->bclhp', Cr.to(f32), s_prev) * \
        torch.exp(a_cs)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p).to(x.dtype)
    return y, s_run[:, -1]


def _ssm_dims(cfg):
    """(d_in, N, headdim, heads) of the Mamba-2 block."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, cfg.ssm_headdim, d_in // cfg.ssm_headdim


def _ssd_seq(p, xBC, dt_raw, cfg):
    """The SSD over a sequence of the conv's output ``xBC`` (B, S, x | B |
    C) and ``dt_raw`` (B, S, heads), for the heads ``p``'s ``A_log``,
    ``D`` and ``dt_bias`` hold (all of them, or a rank's): y (B, S, the
    heads' channels) in ``xBC``'s dtype and the final state."""
    Bsz, S = xBC.shape[:2]
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    h = dt_raw.shape[-1]
    xs, B, C = torch.split(xBC, [h * hd, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p['dt_bias'])      # (B,S,h)
    A = -torch.exp(p['A_log'])
    a = dt * A                                                    # log decay
    xh = xs.reshape(Bsz, S, h, hd)
    xd = xh * dt[..., None].to(xs.dtype)
    L = min(cfg.ssm_chunk, S)
    pad = (-S) % L
    if pad:
        # zero-pad: a = 0 (decay 1) and x/B/C = 0 leave y[:S] and the final
        # state exactly unchanged
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, state = ssd_chunked(xd, a, B, C, cfg.ssm_chunk)
    y = y[:, :S]
    y = y + p['D'].to(y.dtype)[None, None, :, None] * xh
    return y.reshape(Bsz, S, h * hd), state


def _ssd_step(p, xBC, dt_raw, h_state, cfg, dtype):
    """One decode step of the SSD for ``p``'s heads: ``xBC`` (B, x | B |
    C) after the conv, ``h_state`` (B, heads, headdim, N) fp32 updated in
    place.  Returns y (B, the heads' channels) in ``dtype``."""
    Bsz = xBC.shape[0]
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    h = dt_raw.shape[-1]
    xs, B, C = torch.split(xBC, [h * hd, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p['dt_bias'])      # (B,h)
    A = -torch.exp(p['A_log'])
    xh = xs.reshape(Bsz, h, hd).to(torch.float32)
    # h * exp(dt A) + dt x B^T: the outer product is never materialized
    hst = h_state.mul_(torch.exp(dt * A)[..., None, None]).addcmul_(
        (dt[..., None] * xh)[..., None],
        B.to(torch.float32)[:, None, None, :])
    y = torch.einsum('bn,bhpn->bhp', C.to(torch.float32), hst)
    y = y + p['D'][None, :, None] * xh
    return y.reshape(Bsz, h * hd).to(dtype)


def mamba2_forward(p, x, cfg, *, quant=(0, 0), return_state=False):
    """x: (B, S, D) -> (B, S, D).  ``return_state``: also (the final SSD
    state (B, h, p, N) fp32, the conv's last k - 1 inputs), so that decode
    continues after a prefill.  On 'model' shards (``out_proj`` marked
    ``'row'``) :func:`mamba2_tp_forward`."""
    if p['out_proj'].get('tp') == 'row':
        return mamba2_tp_forward(p, x, cfg, current_tp(),
                                 return_state=return_state)
    z, xBC_raw, dt_raw = _split_inproj(cfg, dense(p['in_proj'], x,
                                                  quant=quant))
    xBC = silu(causal_conv1d(p['conv'], xBC_raw))
    y, state = _ssd_seq(p, xBC, dt_raw, cfg)
    y = rms_norm(p['norm'], y * silu(z), cfg.norm_eps)
    out = dense(p['out_proj'], y, quant=quant)
    if return_state:
        return out, (state, xBC_raw[:, -(cfg.ssm_conv - 1):, :])
    return out


def mamba2_decode(p, x, cache, cfg, *, quant=(0, 0)):
    """x: (B, D); cache = {'h': (B, h, p, N) fp32, 'conv': (B, k-1,
    conv_ch)}, written in place.  Returns (out (B, D), cache).  On
    'model' shards :func:`mamba2_tp_decode`."""
    if p['out_proj'].get('tp') == 'row':
        return mamba2_tp_decode(p, x, cache, cfg, current_tp())
    z, xBC0, dt_raw = _split_inproj(cfg, dense(p['in_proj'], x, quant=quant))
    xBC, conv_state = conv1d_step(p['conv'], xBC0, cache['conv'])
    y = _ssd_step(p, silu(xBC), dt_raw, cache['h'], cfg, x.dtype)
    cache['conv'].copy_(conv_state)
    y = rms_norm(p['norm'], y * silu(z), cfg.norm_eps)
    out = dense(p['out_proj'], y, quant=quant)
    return out, cache


# ------------------------------------------- Mamba-2 on its 'model' shards
#
# The sharding rules cut ``in_proj``'s columns, the conv's channels, the
# heads' ``A_log``/``D``/``dt_bias``, the norm's scale and ``out_proj``'s
# rows over 'model', each contiguously.  ``out_proj``'s rows, the norm's
# scale and the per-head leaves then hold this rank's heads (``heads / m``
# of them, channels ``rank * d_in / m ..``), but ``in_proj``'s columns
# [z | x | B | C | dt] and the conv's [x | B | C] are cut across their
# parts.  So the rank computes its contiguous columns of ``in_proj``
# (``1 / m`` of its product), all-gathers them over 'model' and reads its
# heads' z, x and dt and B and C whole (ngroups 1: every head reads them);
# the conv's taps, and in a decode its state, are all-gathered the same
# way and cut to those channels.  The gated RMSNorm spans the whole d_in:
# its sum of squares is summed over 'model'.  ``out_proj`` is a row
# product, summed over 'model' once.  The stages are apart
# (:func:`ssm_in`, :func:`ssm_mix`, :func:`ssm_step`, :func:`ssm_out`) so
# that one process can play every rank and do the collectives itself.


def _rank_cut(cfg, tp):
    """(first channel, channels, first head, heads) of this rank."""
    d_in, _, _, h = _ssm_dims(cfg)
    dl, hl = d_in // tp.size, h // tp.size
    return tp.rank * dl, dl, tp.rank * hl, hl


def _rank_xbc(cfg, t, tp):
    """This rank's x channels and B, C whole, of ``t``'s last dim laid out
    as the conv's channels [x | B | C]."""
    d_in = _ssm_dims(cfg)[0]
    lo, dl, _, _ = _rank_cut(cfg, tp)
    return torch.cat([t[..., lo:lo + dl], t[..., d_in:]], dim=-1)


def _rank_inproj(cfg, zxbcdt, tp):
    """(z, xBC, dt) of this rank's heads from the whole ``in_proj``
    output."""
    d_in, n, _, _ = _ssm_dims(cfg)
    lo, dl, hlo, hl = _rank_cut(cfg, tp)
    dt0 = 2 * d_in + 2 * n
    return (zxbcdt[..., lo:lo + dl],
            _rank_xbc(cfg, zxbcdt[..., d_in:dt0], tp),
            zxbcdt[..., dt0 + hlo:dt0 + hlo + hl])


def _conv_chunk(cfg, t, tp):
    """This rank's contiguous chunk of the conv's channels (the rules'
    cut of the conv state) of ``t``'s last dim."""
    n = t.shape[-1] // tp.size
    return t[..., tp.rank * n:(tp.rank + 1) * n]


def ssm_in(p, x, tp):
    """This rank's columns of ``in_proj`` (a column product)."""
    return dense(p['in_proj'], copy_in(x, tp))


def ssm_mix(p, zxbcdt, conv, cfg, tp, *, return_state=False):
    """From the whole ``in_proj`` output and the whole conv taps ``conv``:
    this rank's gated output ``y * silu(z)`` (B, S, d_in / m), its part of
    the sum of squares over d_in (fp32) and, with ``return_state``, (its
    heads' final state, its chunk of the conv's last k - 1 inputs)."""
    z, xbc_raw, dt_raw = _rank_inproj(cfg, zxbcdt, tp)
    taps = {k: _rank_xbc(cfg, v, tp) for k, v in conv.items()}
    y, state = _ssd_seq(p, silu(causal_conv1d(taps, xbc_raw)), dt_raw,
                        cfg)
    g = y * silu(z)
    ss = torch.sum(torch.square(g.to(torch.float32)), dim=-1, keepdim=True)
    if not return_state:
        return g, ss, None
    d_in, n, _, _ = _ssm_dims(cfg)
    tail = zxbcdt[:, -(cfg.ssm_conv - 1):, d_in:2 * d_in + 2 * n]
    return g, ss, (state, _conv_chunk(cfg, tail, tp))


def ssm_step(p, zxbcdt, conv, conv_state, h_state, cfg, tp, dtype):
    """One decode step from the whole ``in_proj`` output (B, cols), the
    whole conv taps and the whole conv state (B, k-1, C): this rank's
    gated output, its part of the sum of squares and its chunk of the new
    conv state; ``h_state`` (this rank's heads) is updated in place."""
    d_in, n, _, _ = _ssm_dims(cfg)
    z, xbc0, dt_raw = _rank_inproj(cfg, zxbcdt, tp)
    taps = {k: _rank_xbc(cfg, v, tp) for k, v in conv.items()}
    xbc, _ = conv1d_step(taps, xbc0, _rank_xbc(cfg, conv_state, tp))
    y = _ssd_step(p, silu(xbc), dt_raw, h_state, cfg, dtype)
    g = y * silu(z)
    ss = torch.sum(torch.square(g.to(torch.float32)), dim=-1, keepdim=True)
    new = torch.cat([conv_state[:, 1:],
                     zxbcdt[:, None, d_in:2 * d_in + 2 * n]], dim=1)
    return g, ss, _conv_chunk(cfg, new, tp)


def ssm_out(p, g, ss, cfg):
    """This rank's part of ``out_proj`` (its rows, no bias) of the gated
    RMSNorm of ``g``, given the sum of squares ``ss`` over the whole
    d_in."""
    var = ss / _ssm_dims(cfg)[0]
    y = g.to(torch.float32) * torch.rsqrt(var + cfg.norm_eps)
    return row_part(p['out_proj'],
                    (y * p['norm']['scale'].to(torch.float32)).to(g.dtype))


def _sum_both(x, tp):
    """The sum over 'model' whose gradient is summed over 'model' too:
    each rank's part feeds every rank's own channels."""
    return copy_in(reduce_out(x, tp), tp)


def _gathered_conv(p, tp):
    return {k: gather_cols(v, tp) for k, v in p['conv'].items()}


def mamba2_tp_forward(p, x, cfg, tp, *, return_state=False):
    """:func:`mamba2_forward` on this rank's 'model' shards (the comment
    above); the state is its heads' and the conv tail its chunk."""
    zxbcdt = gather_cols(ssm_in(p, x, tp), tp)
    g, ss, st = ssm_mix(p, zxbcdt, _gathered_conv(p, tp), cfg, tp,
                        return_state=return_state)
    out = row_bias(p['out_proj'],
                   reduce_out(ssm_out(p, g, _sum_both(ss, tp), cfg), tp))
    return (out, st) if return_state else out


def mamba2_tp_decode(p, x, cache, cfg, tp):
    """:func:`mamba2_decode` on this rank's 'model' shards: ``cache['h']``
    its heads, ``cache['conv']`` its chunk of the channels."""
    zxbcdt = gather_cols(ssm_in(p, x, tp), tp)
    g, ss, conv = ssm_step(p, zxbcdt, _gathered_conv(p, tp),
                           gather_cols(cache['conv'], tp), cache['h'], cfg,
                           tp, x.dtype)
    cache['conv'].copy_(conv)
    out = row_bias(p['out_proj'],
                   reduce_out(ssm_out(p, g, reduce_out(ss, tp), cfg), tp))
    return out, cache


def mamba2_rank_shard(p, rank, size):
    """A whole Mamba-2 param dict cut to one rank's 'model' shard as the
    sharding rules cut it, and marked as the mesh policy marks it."""
    def cut(t, dim):
        n = t.shape[dim] // size
        return t.narrow(dim, rank * n, n)
    return {'in_proj': rank_shard(p['in_proj'], 'col', rank, size),
            'out_proj': rank_shard(p['out_proj'], 'row', rank, size),
            'conv': {k: cut(v, -1) for k, v in p['conv'].items()},
            **{k: cut(p[k], 0) for k in ('A_log', 'D', 'dt_bias')},
            'norm': {'scale': cut(p['norm']['scale'], 0)}}


def init_mamba2_cache(cfg, batch, dtype, device='cpu', tp=None):
    """The decode state; with ``tp`` (a Mamba-2 block on 'model' shards)
    this rank's chunk of it: its heads of ``h``, its contiguous chunk of
    the conv's channels."""
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    h = d_in // cfg.ssm_headdim
    m = 1 if tp is None else tp.size
    return {'h': torch.zeros((batch, h // m, cfg.ssm_headdim, n),
                             dtype=torch.float32, device=device),
            'conv': torch.zeros((batch, cfg.ssm_conv - 1,
                                 (d_in + 2 * n) // m),
                                dtype=dtype, device=device)}
