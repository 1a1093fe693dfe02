"""Int8 NHWC conv lowered to the quant_matmul kernel through im2col.

SAME-padded im2col turns the conv into ``patches (B*OH*OW, KH*KW*CIN) @
w (KH*KW*CIN, COUT)``; the patch axis is the matmul K axis, and the
dequant + bias + ReLU (or requantize, ``out_scale``) epilogue runs in the
kernel.  Patch extraction is a memory-layout op that stays in PyTorch, as
the reference leaves its ``jnp.take`` outside the Pallas kernel: one int8
gather over the padded plane, with the index tensor cached per geometry
and device.  Symmetric quantization (zero point 0) makes the zero padding
exact in the quantized domain.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.ref import same_pads


def conv_out_hw(h: int, w: int, stride: int) -> tuple[int, int]:
    """SAME-padding output spatial dims."""
    return -(-h // stride), -(-w // stride)


@functools.lru_cache(maxsize=None)
def _im2col_plan(h: int, w: int, kh: int, kw: int, stride: int):
    """Cached im2col geometry: SAME pads, (OH, OW), and the int64 numpy
    index of shape (OH*OW*KH*KW,) into the *padded* HP*WP plane in
    (oh, ow)-major, (kh, kw)-minor order."""
    pads, (oh, ow) = same_pads(h, w, kh, kw, stride)
    wp = w + sum(pads[1])
    rows = np.arange(oh)[:, None] * stride + np.arange(kh)[None, :]
    cols = np.arange(ow)[:, None] * stride + np.arange(kw)[None, :]
    idx = rows[:, None, :, None] * wp + cols[None, :, None, :]
    return pads, (oh, ow), idx.reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _im2col_index(h, w, kh, kw, stride, device: torch.device):
    return torch.from_numpy(_im2col_plan(h, w, kh, kw, stride)[2]).to(device)


def im2col_nhwc(x, kh: int, kw: int, stride: int = 1):
    """SAME im2col: x (B,H,W,C) -> patches (B*OH*OW, KH*KW*C), plus (OH,OW).

    The patch axis is (kh, kw, C)-major, the order of
    ``w.reshape(KH*KW*C, COUT)`` for HWIO weights."""
    B, H, W, C = x.shape
    (ph, pw), (oh, ow), _ = _im2col_plan(H, W, kh, kw, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    flat = xp.reshape(B, xp.shape[1] * xp.shape[2], C)
    idx = _im2col_index(H, W, kh, kw, stride, x.device)
    patches = torch.index_select(flat, 1, idx)
    return patches.reshape(B * oh * ow, kh * kw * C), (oh, ow)


def quant_conv(x_q, w_q, sx, sw, bias=None, *, stride=1, relu=False,
               out_scale=None, out_qmax=127.0):
    """Int8 NHWC conv with the fused epilogue.

    x_q int8 (B,H,W,CIN); w_q int8 (KH,KW,CIN,COUT); sx the per-tensor
    activation scale (a Python float, or a 0-dim fp32 tensor on x's
    device, read there); sw (COUT,) fp32; bias (COUT,) fp32 or None.
    Returns (B,OH,OW,COUT) fp32, or int8 when ``out_scale`` is set."""
    B, H, W, C = x_q.shape
    kh, kw, c2, n = w_q.shape
    if C != c2:
        raise ValueError(f'quant_conv: input has {C} channels, weight {c2}')
    patches, (oh, ow) = im2col_nhwc(x_q, kh, kw, stride)
    m = B * oh * ow
    if isinstance(sx, torch.Tensor):
        sxv = sx.to(torch.float32).reshape(1).expand(m).contiguous()
    else:
        sxv = torch.full((m,), float(sx), dtype=torch.float32,
                         device=x_q.device)
    out = quant_matmul(patches, w_q.reshape(kh * kw * C, n), sxv,
                       sw, bias, relu=relu, out_scale=out_scale,
                       out_qmax=out_qmax)
    return out.reshape(B, oh, ow, n)
