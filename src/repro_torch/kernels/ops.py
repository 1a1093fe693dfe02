"""Public entry points over the kernels (the reference's ``kernels/ops.py``).

The device of the tensor decides: a CUDA tensor goes to the hand-written
kernel (or raises), a CPU tensor to the kernel's plain version.  The
reference's ``use_pallas`` switch is gone for that reason.

* :func:`prequantize_weight` — per-out-channel weight quantization, run
  once at export; (w_q, sw) are static at serve time.
* :func:`quantize_act`, :func:`quant_dense`, :func:`quantize_dense_int8`,
  :func:`quant_conv_nhwc` — the dynamic-scale serving path
  (``export_cnn(calibrate=None)``): one per-tensor (or per-row) abs-max
  of the activation per layer, fp32 between layers.  The reference jits
  them, and XLA folds the scale's ``/ qmax`` into ``* fp32(1/qmax)`` while
  it keeps ``x / s`` a true division by the traced scale (its compiled
  HLO); the port computes both so, bit for bit.  A depthwise conv reads
  its scale on the host (the kernel takes it by value): one device read
  per depthwise layer.
* :func:`quant_conv_static` / :func:`quant_dense_static` — int8 conv/dense
  on an activation already quantized on a static scale; with
  ``out_scale`` the output stays int8 on that static grid.
* :func:`depthwise_conv_static` — the depthwise kernel on a statically
  quantized activation (MobileNet's grouped convs).
* :func:`lowrank_conv_nhwc` — a factored (u, v) conv pair in one launch of
  the fused low-rank kernel, after the im2col gather.
* :func:`decode_attention` / :func:`decode_attention_int8` — one-token GQA
  attention over a bf16/fp32 or an int8 KV cache (the LM decode step).
* :func:`fake_quant` — per-channel weight fake quant (QAT), on the fused
  or the two-pass kernel as the reference routes it.
* :func:`quant_matmul` — the kernel itself (the reference's thin
  wrappers over ``quant_matmul`` and ``decode_attention`` are these
  names: no ``use_pallas`` to pass on).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention, decode_attention_int8)
from repro_torch.kernels.depthwise_conv import depthwise_conv, fits_depthwise
from repro_torch.kernels.fake_quant import fake_quant as fake_quant_two_pass
from repro_torch.kernels.fake_quant import fake_quant_fused
from repro_torch.kernels.lowrank_conv import lowrank_conv
from repro_torch.kernels.quant_conv import im2col_nhwc, quant_conv
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: F401
from repro_torch.kernels.ref import recip32
from repro_torch.kernels.tiling import VMEM_BUDGET


def fake_quant(w, bits=8):
    """Fake-quantize a 2-D fp32 or bf16 w, routed as the reference routes
    it: the fused single-stripe wrapper when a (K, 256) fp32 column stripe
    fits half the reference's VMEM budget, the two-pass wrapper otherwise
    (tinyllama's MLP ``wo``, K = 5632).  On the card both launch the
    cluster kernel of ``csrc/fake_quant.cu``, which reads w once at any K;
    the gate stays so that a weight takes the same wrapper in both
    packages."""
    if w.shape[0] * min(256, w.shape[1]) * 4 <= VMEM_BUDGET // 2:
        return fake_quant_fused(w, bits=bits)
    return fake_quant_two_pass(w, bits=bits)


def prequantize_weight(w, *, bits: int = 8):
    """Per-out-channel (last dim) symmetric int8 weight quantization, through
    core.quantization.quantize_weight (the single weight quantizer).
    Returns (w_q int8, sw (out,) fp32)."""
    from repro_torch.core.quantization import quantize_weight
    w_q, scale = quantize_weight(w.to(torch.float32), bits, axis=-1)
    return w_q.to(torch.int8), scale.reshape(-1).to(torch.float32)


def _act_qmax(a_bits: int) -> float:
    return 2.0 ** (a_bits - 1) - 1.0


def quantize_act(x, *, a_bits: int = 8, per_row: bool = False):
    """Dynamic activation quantization, the only per-call scale compute:
    one per-tensor scale, or with ``per_row`` one per row of a 2-D x.
    The scale is ``max(amax, 1e-8) * recip32(qmax)`` and the codes
    ``round(x / s)``, a true division, as ``jax.jit`` of the reference
    computes them.  Returns (x_q int8, s fp32: 0-dim or (M,))."""
    qmax = _act_qmax(a_bits)
    if per_row:
        s = torch.clamp_min(torch.abs(x).amax(dim=1), 1e-8) * recip32(qmax)
        xq = torch.round(x / s[:, None])
    else:
        s = torch.clamp_min(torch.abs(x).amax(), 1e-8) * recip32(qmax)
        xq = torch.round(x / s)
    xq = torch.clamp(xq, -qmax - 1.0, qmax)
    return xq.to(torch.int8), s.to(torch.float32)


def quant_dense(x, w_q, sw, *, a_bits=8, per_row=True, **kw):
    """Int8 dense with prequantized weights: x fp32 (M,K) @ w_q int8 (K,N)
    on ``quant_matmul``, x quantized per row or per tensor, sw (N,) or
    (1, N) static.  Returns fp32 (M, N)."""
    xq, sx = quantize_act(x, a_bits=a_bits, per_row=per_row)
    if not per_row:
        sx = sx.expand(x.shape[0]).contiguous()
    return quant_matmul(xq, w_q, sx, sw.reshape(-1), **kw)


def quantize_dense_int8(x, w, **kw):
    """Quantize x and an fp32 w to int8 and run the quantized matmul
    (:func:`prequantize_weight` then :func:`quant_dense`)."""
    w_q, sw = prequantize_weight(w)
    return quant_dense(x, w_q, sw, **kw)


def quant_conv_nhwc(x, w_q, sw, bias=None, *, stride=1, groups=1,
                    relu=False, a_bits=8):
    """Int8 NHWC conv with prequantized weights: x fp32 (B,H,W,CIN) on one
    dynamic per-tensor scale (the QAT grid); w_q int8 (KH,KW,CIN,COUT);
    sw (COUT,) static.  A grouped conv with per-group depth 1 runs on
    ``depthwise_conv``; the rest through im2col on ``quant_matmul``.  A
    grouped conv with per-group depth > 1 (no configuration has one) is
    the reference's declared fp32 fallback: ``ref.quant_conv_ref`` on the
    dequantized operands, as the reference runs ``lax.conv``.  Returns
    fp32."""
    xq, sx = quantize_act(x, a_bits=a_bits)
    if groups > 1:
        if not fits_depthwise(w_q.shape):
            return ref.quant_conv_ref(xq, w_q, sx, sw, bias, stride=stride,
                                      relu=relu, groups=groups)
        return depthwise_conv(xq, w_q, float(sx), sw.reshape(-1), bias,
                              stride=stride, relu=relu)
    return quant_conv(xq, w_q, sx, sw.reshape(-1), bias, stride=stride,
                      relu=relu)


def quant_conv_static(x_q, w_q, sw, bias=None, *, sx, stride=1, relu=False,
                      out_scale=None, out_qmax=127.0):
    """Int8 conv on an already-quantized activation with a static scale
    ``sx`` (a Python float from export calibration); no abs-max runs."""
    return quant_conv(x_q, w_q, sx, sw, bias, stride=stride, relu=relu,
                      out_scale=out_scale, out_qmax=out_qmax)


def quant_dense_static(x_q, w_q, sw, bias=None, *, sx, relu=False,
                       out_scale=None, out_qmax=127.0):
    """Int8 dense on a statically-quantized activation: x_q int8 (M,K);
    returns fp32 (M,N), or int8 when ``out_scale`` is set."""
    sxv = torch.full((x_q.shape[0],), float(sx), dtype=torch.float32,
                     device=x_q.device)
    return quant_matmul(x_q, w_q, sxv, sw.reshape(-1), bias, relu=relu,
                        out_scale=out_scale, out_qmax=out_qmax)


def depthwise_conv_static(x_q, w_q, sw, bias=None, *, sx, stride=1,
                          relu=False, out_scale=None, out_qmax=127.0):
    """Int8 depthwise conv on a statically-quantized activation: x_q int8
    (B,H,W,CIN) on the grid ``sx``; w_q int8 (KH,KW,1,COUT) with COUT a
    multiple of CIN.  Returns fp32, or int8 when ``out_scale`` is set."""
    return depthwise_conv(x_q, w_q, sx, sw.reshape(-1), bias, stride=stride,
                          relu=relu, out_scale=out_scale, out_qmax=out_qmax)


def lowrank_conv_nhwc(x_q, u_q, v_q, su, sv, bu, bv, *, sx, h_scale,
                      stride=1, relu=False, out_scale=None, h_qmax=127.0,
                      out_qmax=127.0):
    """A factored conv pair in one launch: x_q int8 (B,H,W,CIN); u_q int8
    (KH,KW,CIN,R); v_q int8 (1,1,R,COUT) or (R,COUT); su/bu (R,), sv/bv
    (COUT,) fp32; ``sx``/``h_scale``/``out_scale`` static floats.  The
    SAME im2col gather runs in PyTorch, then the fused kernel.  Stored
    K-major (``core/export.k_major``), u and v reshape to views with
    strides (1, K1) and (1, R), the layout the kernel reads.  Returns
    (B,OH,OW,COUT) fp32, or int8 when ``out_scale`` is set."""
    B = x_q.shape[0]
    kh, kw, cin, r = u_q.shape
    n = v_q.shape[-1]
    patches, (oh, ow) = im2col_nhwc(x_q, kh, kw, stride)
    out = lowrank_conv(patches, u_q.reshape(kh * kw * cin, r),
                       v_q.reshape(r, n), su.reshape(-1), sv.reshape(-1),
                       bu, bv, sx=sx, h_scale=h_scale, relu=relu,
                       out_scale=out_scale, h_qmax=h_qmax, out_qmax=out_qmax)
    return out.reshape(B, oh, ow, n)
