"""Fixed-point uniform quantization-aware training (the paper's Q pass).

DoReFa-style symmetric per-channel weight quantization and per-tensor
activation quantization with straight-through estimators, in PyTorch.
``quantize_weight`` is the single weight quantizer: QAT
(``fake_quant_weight``) and serving export (``quantize_params_for_serving``,
``ops.prequantize_weight``) all route through it.

The scale ``max(amax, 1e-8) / qmax`` is computed two ways, as in the
reference.  Where the reference runs these functions eagerly (export
calibration, ``quantize_params_for_serving``) it is one IEEE division
(``ref.true_div``: torch's CUDA ``tensor / python_float`` would multiply
by a reciprocal).  Where the reference jits them (the training step,
``repro/core/passes.py``), XLA folds ``/ qmax`` into ``* fp32(1/qmax)``;
inside :func:`jitted_scales`, which ``Trainer.train_step`` enters around
its forward and backward pass and ``Trainer.evaluate`` around its
accuracy forward, the port multiplies by ``recip32(qmax)`` too, as its
fake-quant kernels always do.
"""
from __future__ import annotations

import contextlib
import itertools

import torch

from repro_torch.kernels.ref import recip32, true_div
from repro_torch.tree import tree_leaves


def _ste(x_q, x):
    """Straight-through estimator: forward x_q, gradient of identity."""
    return x + (x_q - x).detach()


@contextlib.contextmanager
def full_fp32():
    """fp32 convs and matmuls in full precision inside this block, as the
    reference's CPU arithmetic runs them (cuDNN would run fp32 convs in
    TF32 by default, which moves every abs-max scale).  The export's
    calibration, ``Trainer``'s step and evaluation and
    ``CNNFamily.exit_stats`` enter it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# True inside jitted_scales(): the scale multiplies by recip32(qmax).
_JITTED = [False]


@contextlib.contextmanager
def jitted_scales():
    """Compute QAT scales with the reference's jitted arithmetic,
    ``max(amax, 1e-8) * recip32(qmax)``, inside this block (the training
    step and the evaluation forward); outside it they divide, as the reference's eager calls do.  The
    bits=1 DoReFa mean is the same either way."""
    prev, _JITTED[0] = _JITTED[0], True
    try:
        yield
    finally:
        _JITTED[0] = prev


def _scale(amax, qmax: float):
    """``max(amax, 1e-8) / qmax`` under the arithmetic in force."""
    amax = torch.clamp_min(amax, 1e-8)
    return amax * recip32(qmax) if _JITTED[0] else true_div(amax, qmax)


# Counts weight abs-max (scale) computations.  The export tests use it to
# prove that serving recomputes no weight scale per call.
WEIGHT_SCALE_COMPUTATIONS = [0]


def _reduced_dims(ndim: int, axis) -> tuple | None:
    if axis is None:
        return None
    kept = {a % ndim for a in ((axis,) if isinstance(axis, int)
                               else tuple(axis))}
    return tuple(i for i in range(ndim) if i not in kept)


def quantize_weight(w, bits: int, *, axis=-1):
    """Symmetric per-channel int quantization. Returns (int_values, scale).

    ``axis`` is the axis (or tuple of axes) that keep their own scale
    (None = per-tensor).  bits=1 follows DoReFa binary weights
    (sign * mean|w|)."""
    WEIGHT_SCALE_COMPUTATIONS[0] += 1
    red = _reduced_dims(w.dim(), axis)
    if bits == 1:
        dims = tuple(range(w.dim())) if red is None else red
        scale = torch.abs(w).mean(dim=dims, keepdim=True) if dims \
            else torch.abs(w)
        q = torch.sign(w)
        q = torch.where(q == 0, torch.ones_like(q), q)
        return q.to(torch.int8), scale
    qmax = 2.0 ** (bits - 1) - 1.0
    if red is None:
        amax = torch.abs(w).amax()
    elif red:
        amax = torch.abs(w).amax(dim=red, keepdim=True)
    else:
        amax = torch.abs(w)
    scale = _scale(amax, qmax)
    q = torch.clamp(torch.round(w / scale), -qmax - 1.0, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32), scale


class _KernelFakeQuantSTE(torch.autograd.Function):
    """The fake-quant kernels (``ops.fake_quant``: fused, or the two-pass
    pair for a long K) under a straight-through estimator: the forward
    pass returns w's dtype (fp32 math inside, as the reference's kernels),
    the backward pass is the identity, so the gradient reaches a stacked
    ``(G, ...)`` leaf through the view ``leaf[g]`` it was given."""

    @staticmethod
    def forward(ctx, w, bits):
        from repro_torch.kernels.ops import fake_quant
        return fake_quant(w.contiguous(), bits).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_weight(w, bits: int, *, axis=-1, use_kernel=None):
    """Quantize->dequantize with STE (QAT forward for weights).

    On a CUDA tensor the 2-D last-axis case runs the fake-quant kernels
    (kernels/fake_quant.py, routed by ``ops.fake_quant``); the CPU, other
    shapes and axes, and the bits=1 DoReFa grid stay on plain tensor ops,
    in w's dtype, as the reference's CPU path does."""
    if bits <= 0 or bits >= 32:
        return w
    if use_kernel is None:
        use_kernel = (w.is_cuda and w.dim() == 2 and bits > 1
                      and axis in (-1, 1))
    if use_kernel:
        return _KernelFakeQuantSTE.apply(w, bits)
    q, scale = quantize_weight(w, bits, axis=axis)
    return _ste(q.to(w.dtype) * scale.to(w.dtype), w)


def fake_quant_act(x, bits: int, *, amax: float | None = None):
    """Activation fake-quant: symmetric uniform with a per-tensor abs-max
    clip of the current batch (or a given ``amax``); the scale carries no
    gradient."""
    if bits <= 0 or bits >= 32:
        return x
    qmax = 2.0 ** (bits - 1) - 1.0
    s = torch.abs(x).amax() if amax is None else \
        torch.full((), amax, dtype=x.dtype, device=x.device)
    s = _scale(s.detach(), qmax)
    xq = torch.clamp(torch.round(x / s), -qmax - 1.0, qmax) * s
    return _ste(xq.to(x.dtype), x)


def quantize_params_for_serving(params, bits: int = 8):
    """Convert every matmul/conv weight to int8 + per-out-channel scales.

    Dense weights (d,f) and scan-stacked (G,d,f) keep their scale shape
    with the reduced axis kept as 1; 4D NHWC conv weights (KH,KW,CIN,COUT)
    get flat (COUT,) scales, as quant_conv consumes them.  MoE expert
    weights (raw ``wi``/``wg``/``wo`` tensors of (E,d,f) or stacked
    (G,E,d,f)) become ``{'w_q', 'scale'}`` with the scale kept over every
    axis but -2, quantized one (d, f) slice at a time: the scale reduces
    over axis -2 only, so the codes and scales are those of the whole
    leaf, without its fp32 copies (a stacked mixtral-8x7b leaf is 5.6 G
    elements at 12 layers).  The router ``{'w'}`` is a dense weight.
    Norm params, biases, MLA's raw up-projections ``wk_b``/``wv_b`` and
    recurrent conv taps (under a 'conv' key) stay as they are."""
    def quant(v, flat_scale=False):
        v = v.to(torch.float32)
        if flat_scale:
            q, scale = quantize_weight(v, bits, axis=-1)
            scale = scale.reshape(-1)
        else:
            kept = tuple(i for i in range(v.dim()) if i != v.dim() - 2)
            q, scale = quantize_weight(v, bits, axis=kept)
        return q.to(torch.int8), scale.to(torch.float32)

    def quant_slices(v):
        q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
        s = torch.empty((*v.shape[:-2], 1, v.shape[-1]), dtype=torch.float32,
                        device=v.device)
        for lead in itertools.product(*map(range, v.shape[:-2])):
            q[lead], s[lead] = quant(v[lead])
        return q, s

    def convert(node, name=''):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if name != 'conv' and k == 'w' and \
                        isinstance(v, torch.Tensor) and v.dim() in (2, 3):
                    out['w_q'], out['scale'] = quant(v)
                elif k == 'w' and isinstance(v, torch.Tensor) \
                        and v.dim() == 4:
                    out['w_q'], out['scale'] = quant(v, flat_scale=True)
                elif k in ('wi', 'wg', 'wo') and \
                        isinstance(v, torch.Tensor) and v.dim() in (3, 4):
                    q, s = quant_slices(v)
                    out[k] = {'w_q': q, 'scale': s}
                else:
                    out[k] = convert(v, k)
            return out
        if isinstance(node, list):
            return [convert(v, name) for v in node]
        if isinstance(node, tuple):
            return tuple(convert(v, name) for v in node)
        return node

    return convert(params)


def quantized_params_bits(params, bits: int) -> int:
    """Total storage bits of a params tree at ``bits`` per element."""
    return sum(t.numel() for t in tree_leaves(params)) * bits
