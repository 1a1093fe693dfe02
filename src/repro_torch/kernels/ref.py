"""Plain PyTorch versions of the kernels: what each kernel computes, op by
op, in the order the kernel computes it.

The CPU path runs these (a kernel wrapper takes them only for a CPU
tensor), the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds each CUDA/Triton kernel against them on the card.

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


def quant_matmul_ref(x_q, w_q, sx, sw, out_dtype=torch.float32):
    """int8 x (M,K) @ int8 w (K,N), per-row sx (M,), per-col sw (N,).

    The product accumulates in float64 and is cast to int32: exact for any
    |acc| < 2**53, and it runs on the CPU and on CUDA, where torch has no
    general int32 matmul."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    scale = sx[:, None] * sw[None, :]
    return (acc.to(torch.float32) * scale).to(out_dtype)


def fake_quant_ref(w, bits: int):
    """Per-output-channel (last dim) symmetric fake quantization of a 2-D w,
    with the reference kernel's compiled arithmetic (scale = amax times the
    fp32 reciprocal of qmax; one true division per element)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * recip32(qmax)
    q = torch.clamp(torch.round(w / scale), -qmax - 1.0, qmax)
    return q * scale


def quant_conv_ref(x_q, w_q, sx, sw, bias=None, *, stride=1, relu=False,
                   groups=1, out_dtype=torch.float32, out_scale=None,
                   out_qmax=127.0):
    """fp32-conv oracle for quant_conv: dequantize both operands and run the
    SAME conv (bilinear, so it equals the int8 path up to fp32 rounding).
    x_q int8 NHWC, w_q int8 HWIO, sx scalar, sw (COUT,)."""
    x = x_q.to(torch.float32) * float(sx)
    w = w_q.to(torch.float32) * sw.to(torch.float32)[None, None, None, :]
    y = conv2d_same_nhwc(x, w, stride, groups)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is not None:
        return requantize(y, out_scale, out_qmax)
    return y.to(out_dtype)
