"""Plain PyTorch versions of the kernels: what each kernel computes, op by
op, in the order the kernel computes it.

The CPU path runs these (a kernel wrapper takes them only for a CPU
tensor), the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

Division by a static scale.  The reference runs its requantize epilogue
and its fake-quant scale inside ``jit``, where XLA rewrites ``y / c`` for a
constant ``c`` into ``y * fp32(1/c)``.  :func:`recip32` gives that fp32
reciprocal; the kernels and these versions multiply by it, so int8 codes
match the reference.  A *tensor* divisor stays a true division
(:func:`true_div`): torch's CUDA ``tensor / python_float`` would silently
take the reciprocal path too, so a scalar that must divide is made a
0-dim tensor first.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def recip32(s: float) -> float:
    """The fp32 reciprocal of ``s`` (IEEE fp32 division, as XLA folds a
    constant divisor), returned as the Python float holding that value."""
    return float(np.float32(1.0) / np.float32(s))


def true_div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` rounded as one IEEE division on every device."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


def same_pads(h: int, w: int, kh: int, kw: int, stride: int):
    """SAME padding ((top, bottom), (left, right)) and output (OH, OW).

    At stride 2 on an even size the pad is asymmetric, (0, 1): the extra
    row and column go after the plane, as in XLA's SAME."""
    oh, ow = -(-h // stride), -(-w // stride)
    pad_h = max((oh - 1) * stride + kh - h, 0)
    pad_w = max((ow - 1) * stride + kw - w, 0)
    return ((pad_h // 2, pad_h - pad_h // 2),
            (pad_w // 2, pad_w - pad_w // 2)), (oh, ow)


def conv2d_same_nhwc(x, w, stride: int = 1, groups: int = 1):
    """fp32 SAME conv on NHWC x and HWIO w, returning NHWC.

    Pads explicitly and convolves with ``padding=0``: ``F.conv2d``'s own
    padding is symmetric and cannot express SAME's (0, 1) at stride 2."""
    kh, kw = w.shape[0], w.shape[1]
    (ph, pw), _ = same_pads(x.shape[1], x.shape[2], kh, kw, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def requantize(y, out_scale, qmax=127.0):
    """Static requantize: fp32 -> int8 on the ``out_scale`` grid (multiply
    by the fp32 reciprocal, round half to even, clip, cast)."""
    q = torch.round(y * recip32(out_scale))
    return torch.clamp(q, -qmax - 1.0, qmax).to(torch.int8)


def int_matmul(x_q, w_q):
    """Exact int32 product of int8 x (M,K) and w (K,N).

    It accumulates in float64 and is cast to int32: exact for any
    |acc| < 2**53, and it runs on the CPU and on CUDA, where torch has no
    general int32 matmul."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def fake_quant_ref(w, bits: int):
    """Per-output-channel (last dim) symmetric fake quantization of a 2-D w,
    with the reference kernel's compiled arithmetic (scale = amax times the
    fp32 reciprocal of qmax; one true division per element)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * recip32(qmax)
    q = torch.clamp(torch.round(w / scale), -qmax - 1.0, qmax)
    return q * scale


def epilogue(acc, scale, bias, relu, out_scale, out_qmax):
    """The kernels' shared epilogue on an exact integer accumulator, in their
    op order: ``acc * scale``, bias, ReLU, then the static requantize."""
    y = acc.to(torch.float32) * scale
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is not None:
        return requantize(y, out_scale, out_qmax)
    return y


def depthwise_conv_ref(x_q, w_q, sx, sw, bias=None, *, stride=1, relu=False,
                       out_scale=None, out_qmax=127.0):
    """The depthwise kernel's function: x_q int8 (B,H,W,CIN), w_q int8
    (KH,KW,1,COUT) with COUT a multiple of CIN (output channel ``o`` reads
    input channel ``o // (COUT // CIN)``), sx a static float, sw/bias
    (COUT,).  The SAME conv runs in float64 on the raw integer codes, which
    is exact (every partial sum is an integer far below 2**53), so the
    accumulator equals the kernel's int32 one; then the shared epilogue
    with ``scale = fp32(sx) * sw``."""
    acc = conv2d_same_nhwc(x_q.to(torch.float64), w_q.to(torch.float64),
                           stride, groups=x_q.shape[-1])
    scale = torch.full((), sx, dtype=torch.float32, device=sw.device) * sw
    return epilogue(acc.to(torch.int32), scale, bias, relu, out_scale,
                    out_qmax)


def lowrank_conv_ref(patches, u_q, v_q, su, sv, bu, bv, *, sx, h_scale,
                     relu=False, out_scale=None, h_qmax=127.0,
                     out_qmax=127.0):
    """The fused low-rank kernel's function on im2col patches (M, K1): the
    chained pair on the int path.  ``patches @ u_q`` with the epilogue
    ``acc * (sx * su) + bu`` requantized to int8 h on ``h_scale``, then
    ``h @ v_q`` with ``acc * (h_scale * sv) + bv`` (ReLU, requantize).
    The reference's kernel is bit-exact with this chained pair
    (src/repro/kernels/lowrank_conv.py), not with its own dequantized
    ``lowrank_conv_ref``."""
    def scale(s, sw):       # the kernels' per-element fp32(s) * sw[n]
        return torch.full((patches.shape[0], 1), s, dtype=torch.float32,
                          device=sw.device) * sw[None, :]

    h = epilogue(int_matmul(patches, u_q), scale(sx, su), bu, False,
                 h_scale, h_qmax)
    return epilogue(int_matmul(h, v_q), scale(h_scale, sv), bv, relu,
                    out_scale, out_qmax)


def quant_conv_ref(x_q, w_q, sx, sw, bias=None, *, stride=1, relu=False,
                   groups=1, out_dtype=torch.float32, out_scale=None,
                   out_qmax=127.0):
    """fp32-conv oracle for quant_conv: dequantize both operands and run the
    SAME conv (bilinear, so it equals the int8 path up to fp32 rounding).
    x_q int8 NHWC, w_q int8 HWIO, sx scalar, sw (COUT,).  The conv runs in
    fp32 on the card too (cuDNN's TF32 off), as it serves the grouped-conv
    fp32 fallback."""
    x = x_q.to(torch.float32) * float(sx)
    w = w_q.to(torch.float32) * sw.to(torch.float32)[None, None, None, :]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = conv2d_same_nhwc(x, w, stride, groups)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    if bias is not None:
        y = y + bias.to(torch.float32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is not None:
        return requantize(y, out_scale, out_qmax)
    return y.to(out_dtype)


def decode_attention_ref(q, k, v, valid):
    """GQA decode oracle, the reference's ``decode_attention_ref``: q
    (B,H,D); k, v (B,S,K,D); valid (B,S) bool.  q is scaled by ``D**-0.5``
    in its own dtype, the logits and the softmax are fp32, masked slots
    get -1e30, and the result is cast to q's dtype."""
    B, H, D = q.shape
    K = k.shape[2]
    g = H // K
    qg = q.reshape(B, K, g, D) * (D ** -0.5)
    logits = torch.einsum('bkgd,bskd->bkgs', qg.to(torch.float32),
                          k.to(torch.float32))
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, device=logits.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum('bkgs,bskd->bkgd', p, v.to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)
