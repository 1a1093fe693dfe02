"""Recurrent blocks of the LM side: RG-LRU (recurrentgemma/Griffin) and
Mamba-2's SSD, in PyTorch.

The reference's ``models/recurrent.py``.  Prefill runs the linear
recurrence ``h_t = a_t h_{t-1} + b_t`` over the sequence with
:func:`linear_scan`, a log-depth doubling scan in torch ops where the
reference calls ``jax.lax.associative_scan`` (the two associate the
products in other orders: the same function up to fp32 rounding).  SSD
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
                                       init_conv1d, init_dense, rms_norm)


def linear_scan(a, b):
    """All states of ``h_t = a_t * h_{t-1} + b_t`` along axis 1, from
    ``h_{-1} = 0``: ``a`` broadcasts against ``b`` (the same number of
    axes).  Hillis-Steele doubling: log2(n) steps, each over the whole
    sequence, where the reference composes ``(al, bl), (ar, br) ->
    (al * ar, ar * bl + br)`` with ``jax.lax.associative_scan``."""
    n, d = b.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < n:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


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


def _rglru_gates(p, u, quant):
    """(a, b) of the recurrence in fp32.  ``F.softplus`` returns x above
    20, where JAX adds log1p(exp(-x)); in fp32 that rounds to x."""
    r = torch.sigmoid(dense(p['w_r'], u, quant=quant).to(torch.float32))
    i = torch.sigmoid(dense(p['w_i'], u, quant=quant).to(torch.float32))
    log_a = -_RGLRU_C * F.softplus(p['lam'].to(torch.float32)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * i * u.to(torch.float32)
    return a, b


def rglru_forward(p, x, cfg, *, quant=(0, 0), return_state=False):
    """x: (B, S, D) -> (B, S, D).  ``return_state``: also the decode state
    after the sequence, ``{'h': the last fp32 state (B, W), 'conv': the
    last k - 1 inputs of the conv}``."""
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
    in place.  Returns (out (B, D), cache)."""
    gate = F.gelu(dense(p['wgate'], x, quant=quant), approximate='tanh')
    u0 = dense(p['wx'], x, quant=quant)
    u, conv_state = conv1d_step(p['conv'], u0, cache['conv'])
    a, b = _rglru_gates(p, u, quant)
    h = cache['h'].mul_(a).add_(b)
    cache['conv'].copy_(conv_state)
    out = dense(p['wo'], h.to(x.dtype) * gate, quant=quant)
    return out, cache


def init_rglru_cache(cfg, batch, dtype, device='cpu'):
    w = cfg.rglru_width
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


def mamba2_forward(p, x, cfg, *, quant=(0, 0), return_state=False):
    """x: (B, S, D) -> (B, S, D).  ``return_state``: also (the final SSD
    state (B, h, p, N) fp32, the conv's last k - 1 inputs), so that decode
    continues after a prefill."""
    Bsz, S, D = x.shape
    d_in = cfg.ssm_expand * D
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    h = d_in // hd
    z, xBC_raw, dt_raw = _split_inproj(cfg, dense(p['in_proj'], x,
                                                  quant=quant))
    xBC = F.silu(causal_conv1d(p['conv'], xBC_raw))
    xs, B, C = torch.split(xBC, [d_in, n, n], dim=-1)
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
    y = y.reshape(Bsz, S, d_in)
    y = rms_norm(p['norm'], y * F.silu(z), cfg.norm_eps)
    out = dense(p['out_proj'], y, quant=quant)
    if return_state:
        return out, (state, xBC_raw[:, -(cfg.ssm_conv - 1):, :])
    return out


def mamba2_decode(p, x, cache, cfg, *, quant=(0, 0)):
    """x: (B, D); cache = {'h': (B, h, p, N) fp32, 'conv': (B, k-1,
    conv_ch)}, written in place.  Returns (out (B, D), cache)."""
    Bsz, D = x.shape
    d_in = cfg.ssm_expand * D
    n, hd = cfg.ssm_state, cfg.ssm_headdim
    h = d_in // hd
    z, xBC0, dt_raw = _split_inproj(cfg, dense(p['in_proj'], x, quant=quant))
    xBC, conv_state = conv1d_step(p['conv'], xBC0, cache['conv'])
    xBC = F.silu(xBC)
    xs, B, C = torch.split(xBC, [d_in, n, n], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + p['dt_bias'])      # (B,h)
    A = -torch.exp(p['A_log'])
    xh = xs.reshape(Bsz, h, hd).to(torch.float32)
    # h * exp(dt A) + dt x B^T: the outer product is never materialized
    hst = cache['h'].mul_(torch.exp(dt * A)[..., None, None]).addcmul_(
        (dt[..., None] * xh)[..., None],
        B.to(torch.float32)[:, None, None, :])
    cache['conv'].copy_(conv_state)
    y = torch.einsum('bn,bhpn->bhp', C.to(torch.float32), hst)
    y = y + p['D'][None, :, None] * xh
    y = y.reshape(Bsz, d_in).to(x.dtype)
    y = rms_norm(p['norm'], y * F.silu(z), cfg.norm_eps)
    out = dense(p['out_proj'], y, quant=quant)
    return out, cache


def init_mamba2_cache(cfg, batch, dtype, device='cpu'):
    d_in = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    h = d_in // cfg.ssm_headdim
    return {'h': torch.zeros((batch, h, cfg.ssm_headdim, n),
                             dtype=torch.float32, device=device),
            'conv': torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=dtype, device=device)}
