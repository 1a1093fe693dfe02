"""Core functional layers of the LM side, in PyTorch (params as nested
dicts of tensors, the reference's trees).

Every matmul routes through :func:`dense`, which applies the fixed-point
fake quantization when ``quant=(w_bits, a_bits)`` is set, and also takes
the int8 serving form ``{'w_q', 'scale'}`` and the factored form
``{'u', 'v'}``.  The dense products stay ``torch.matmul``: the reference
leaves them to XLA, outside any Pallas kernel.  The dtype flow is the
reference's: :func:`rms_norm` and :func:`rope` compute in fp32 and cast
back, and the int8 form dequantizes as ``w_q.to(x.dtype) *
scale.to(x.dtype)`` before the product.

Initializers take a ``torch.Generator`` and a device (weights are drawn
where they live, full-width ones on the card) and a ``stack`` prefix that
gives a scan-stacked ``(G, ...)`` leaf in one draw, where the reference
vmaps the init over split keys.  The two packages draw different numbers
from the same seed: tests carry weights across with ``interop``.
Under the mesh policy's tensor parallelism (``models/tp.py``) a dense
dict marked ``'tp'`` is this rank's 'model' shard: :func:`mlp` then runs
:func:`mlp_partial` and sums it over 'model', :func:`embed` looks up this
rank's vocab rows and sums, and :func:`unembed` gives this rank's vocab
chunk of the logits.
The recurrent blocks (``models/recurrent.py``) share the causal depthwise
conv: :func:`causal_conv1d` over a sequence and :func:`conv1d_step` for
one decode step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import fake_quant_act, fake_quant_weight
from repro_torch.models.tp import (copy_in, current_tp, reduce_out,
                                   vocab_embed, whole_table_product)

# --------------------------------------------------------------------- init


def he_init(gen, shape, fan_in, dtype=torch.float32, device='cpu'):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * \
        (1.0 / math.sqrt(max(fan_in, 1)))


def init_dense(gen, d_in, d_out, *, bias=False, dtype=torch.float32,
               device='cpu', stack=()):
    p = {'w': he_init(gen, (*stack, d_in, d_out), d_in, dtype, device)}
    if bias:
        p['b'] = torch.zeros((*stack, d_out), dtype=dtype, device=device)
    return p


def init_norm(d, dtype=torch.float32, device='cpu', stack=()):
    return {'scale': torch.ones((*stack, d), dtype=dtype, device=device)}


# -------------------------------------------------------------------- apply


def dense(p, x, *, quant=(0, 0)):
    """x @ w (+b), with optional fake quant of the weight (per out-channel)
    and the activation; also the int8 serving form {'w_q', 'scale'} and
    the factored form {'u', 'v'} (two chained products)."""
    if 'u' in p and 'v' in p:
        return dense(p['v'], dense(p['u'], x, quant=quant), quant=quant)
    w_bits, a_bits = quant
    if 'w_q' in p:
        w = p['w_q'].to(x.dtype) * p['scale'].to(x.dtype)
        if a_bits:
            x = fake_quant_act(x, a_bits)
        y = torch.matmul(x, w)
        if 'b' in p:
            y = y + p['b'].to(x.dtype)
        return y
    w = p['w']
    if w_bits:
        w = fake_quant_weight(w, w_bits, axis=-1)
    if a_bits:
        x = fake_quant_act(x, a_bits)
    y = torch.matmul(x, w.to(x.dtype))
    if 'b' in p:
        y = y + p['b'].to(x.dtype)
    return y


def rms_norm(p, x, eps=1e-6):
    """RMSNorm in fp32, cast back.  With no gradient to take, the fp32
    copy of a narrower ``x`` is scaled in place (the same numbers, one
    fp32 copy live where there would be three)."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    if xf is not x and not torch.is_grad_enabled():
        xf.mul_(torch.rsqrt(var + eps))
        return xf.mul_(p['scale'].to(torch.float32)).to(dt)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * p['scale'].to(torch.float32)).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


class _SiLU(torch.autograd.Function):
    """``x * sigmoid(x)``, as ``jax.nn.silu`` writes it (``F.silu``
    rounds otherwise in about a quarter of the elements), keeping only
    ``x`` for the backward, as ``F.silu`` does.  The backward is the
    reference's transpose, ``g * s + (g * x) * (s * (1 - s))``, with
    ``g * s`` fused into the sum as XLA fuses it (``addcmul``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sigmoid(x).mul_(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        s = torch.sigmoid(x)
        ds = torch.rsub(s, 1).mul_(s)
        return (g * x).mul_(ds).addcmul_(g, s)


def silu(x):
    """SiLU rounded as the reference's (:class:`_SiLU`)."""
    return _SiLU.apply(x)


# --------------------------------------------------------------------- rope


def rope(x, positions, *, theta=10_000.0):
    """Rotary embedding. x: (..., S, H, D) with positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq      # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                        # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- mlp


def init_mlp(gen, cfg, d_ff=None, *, gated=True, dtype=torch.float32,
             device='cpu', stack=()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=dtype, device=device, stack=stack)
    if gated:
        return {'wi': init_dense(gen, d, f, **kw),
                'wg': init_dense(gen, d, f, **kw),
                'wo': init_dense(gen, f, d, **kw)}
    return {'wi': init_dense(gen, d, f, **kw),
            'wo': init_dense(gen, f, d, **kw)}


def _hidden(p, x, quant):
    if 'wg' in p:  # gated (swiglu)
        return silu(dense(p['wg'], x, quant=quant)) * \
            dense(p['wi'], x, quant=quant)
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(dense(p['wi'], x, quant=quant), approximate='tanh')


def mlp(p, x, *, quant=(0, 0)):
    """The MLP; on 'model' shards (``p['wo']`` marked ``'row'``, the
    mesh policy's tensor-parallel form) each rank's part summed over
    'model'."""
    if p['wo'].get('tp') == 'row':
        tp = current_tp()
        return row_bias(p['wo'], reduce_out(mlp_partial(p, x, tp), tp))
    return dense(p['wo'], _hidden(p, x, quant), quant=quant)


def mlp_partial(p, x, tp):
    """This rank's part of the MLP before the sum over 'model': ``wi`` and
    ``wg`` its columns of the hidden dim, ``wo`` its rows (``wo``'s bias,
    if any, is added once after the sum)."""
    return row_part(p['wo'], _hidden(p, copy_in(x, tp), (0, 0)))


def row_part(p, x):
    """A row product's part: ``x`` times this rank's rows, no bias."""
    return dense({k: v for k, v in p.items() if k not in ('b', 'tp')}, x)


def row_bias(p, y):
    """``y`` (a row product's sum) plus its bias, if any."""
    return y + p['b'].to(y.dtype) if 'b' in p else y


# ---------------------------------------------------------------- embedding


def init_embedding(gen, vocab, d, dtype=torch.float32, device='cpu'):
    return {'table': torch.randn((vocab, d), generator=gen, dtype=dtype,
                                 device=device) * 0.02}


def embed(p, tokens, dtype):
    """The rows of ``tokens``; on a vocab shard (marked ``'vocab'``) each
    rank's rows summed over 'model'."""
    if p.get('tp') == 'vocab':
        tp = current_tp()
        return reduce_out(vocab_embed(p['table'], tokens, dtype, tp), tp)
    return p['table'][tokens].to(dtype)


def unembed(p, x, *, quant=(0, 0)):
    """Logits over the vocab; on a vocab shard, this rank's chunk of
    them.  A table whole on 'model' under tensor parallelism splits its
    weight gradient over 'model' (``tp.whole_table_product``)."""
    w = p['table']
    vocab = p.get('tp') == 'vocab'
    if vocab:
        x = copy_in(x, current_tp())
    if quant[0]:
        w = fake_quant_weight(w, quant[0], axis=0)
    if quant[1]:
        x = fake_quant_act(x, quant[1])
    w = w.to(x.dtype)
    return torch.matmul(x, w.t()) if vocab else whole_table_product(x, w)


# ------------------------------------------------------ causal depthwise conv


def init_conv1d(gen, width, k, dtype=torch.float32, device='cpu', stack=()):
    return {'w': he_init(gen, (*stack, k, width), k, dtype, device),
            'b': torch.zeros((*stack, width), dtype=dtype, device=device)}


def causal_conv1d(p, x):
    """Depthwise causal conv.  x: (B, S, C) -> (B, S, C): ``y[t] = sum_j
    w[j] * x[t + j - (k - 1)]`` over k - 1 leading zeros (the reference's
    ``conv_general_dilated`` with ``feature_group_count=C``), a k-tap sum
    in fp32 rounded to x's dtype, then the bias."""
    w = p['w']
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).to(torch.float32)
    wf = w.to(x.dtype).to(torch.float32)
    y = xp[:, 0:S] * wf[0]
    for j in range(1, k):
        y = y + xp[:, j:j + S] * wf[j]
    return y.to(x.dtype) + p['b'].to(x.dtype)


def conv1d_step(p, x_t, conv_state):
    """One decode step of the causal depthwise conv.

    x_t: (B, C); conv_state: (B, k-1, C), the past inputs.  Returns
    (y_t, new_state), the state the last k - 1 inputs."""
    k = p['w'].shape[0]
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B,k,C)
    y = torch.einsum('bkc,kc->bc', window.to(torch.float32),
                     p['w'].to(x_t.dtype).to(torch.float32)).to(x_t.dtype)
    y = y + p['b'].to(y.dtype)
    return y, window[:, 1:k, :]
