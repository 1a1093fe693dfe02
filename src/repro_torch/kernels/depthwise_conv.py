"""Int8 depthwise conv: the hand-written CUDA kernel
(``csrc/depthwise_conv.cu``), its wrapper and its plain version.

Replaces the reference's Pallas ``depthwise_conv`` / ``_dw_kernel``
(src/repro/kernels/depthwise_conv.py): a direct SAME conv with per-group
input depth 1, int32 multiply-accumulates over the KH x KW taps on the raw
int8 codes, then the epilogue shared with ``quant_matmul``
(``acc * (sx * sw[o])``, bias, ReLU, optional static requantize to int8).
A channel multiplier reads input channel ``o // (COUT // CIN)`` for output
channel ``o``.  The reference pads the plane and the channels to 128 and
repeats the input for a multiplier; the CUDA kernel masks the SAME border
and indexes the multiplier instead, so nothing is padded or copied in
device memory.

:func:`depthwise_conv` launches the kernel for a CUDA tensor and runs
:func:`depthwise_conv_plain` for a CPU tensor; ``depthwise_conv.launches``
and ``depthwise_conv_plain.calls`` count each.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import depthwise_conv_ref, recip32, same_pads

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + \
    [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_LAUNCH = []         # the bound C entry point, set up on first launch


def _launcher():
    if not _LAUNCH:
        fn = _build.load('depthwise_conv').depthwise_conv_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def fits_depthwise(w_shape) -> bool:
    """Can this grouped conv serve on the depthwise kernel?  True for
    per-group input depth 1 (HWIO weight ``(KH, KW, 1, COUT)``): plain
    depthwise and channel-multiplier variants.  The same test as the
    reference's, so plan decisions match."""
    return len(w_shape) == 4 and w_shape[2] == 1


def depthwise_conv_plain(x_q, w_q, sx, sw, bias=None, *, stride=1,
                         relu=False, out_scale=None, out_qmax=127.0):
    """The kernel's function in plain PyTorch, in the kernel's op order."""
    depthwise_conv_plain.calls += 1
    return depthwise_conv_ref(x_q, w_q, sx, sw, bias, stride=stride,
                              relu=relu, out_scale=out_scale,
                              out_qmax=out_qmax)


depthwise_conv_plain.calls = 0


def _check_operands(x_q, w_q, sw, bias):
    if x_q.dim() != 4 or w_q.dim() != 4 or not fits_depthwise(w_q.shape) \
            or w_q.shape[3] % x_q.shape[3]:
        raise ValueError(f'depthwise_conv: x {tuple(x_q.shape)} and w '
                         f'{tuple(w_q.shape)} are not (B,H,W,CIN) and '
                         f'(KH,KW,1,m*CIN)')
    n = w_q.shape[3]
    want = [(x_q, torch.int8, None), (w_q, torch.int8, None),
            (sw, torch.float32, (n,))]
    if bias is not None:
        want.append((bias, torch.float32, (n,)))
    _build.check_operands('depthwise_conv', x_q.device, want)


def depthwise_conv(x_q, w_q, sx, sw, bias=None, *, stride=1, relu=False,
                   out_scale=None, out_qmax=127.0):
    """x_q int8 (B,H,W,CIN); w_q int8 (KH,KW,1,COUT), COUT a multiple of
    CIN; sx the static per-tensor activation scale (a Python float); sw
    fp32 (COUT,); bias fp32 (COUT,) or None.  Returns (B,OH,OW,COUT) fp32,
    or int8 when ``out_scale`` (a static Python float) is set."""
    if not x_q.is_cuda:
        return depthwise_conv_plain(x_q, w_q, sx, sw, bias, stride=stride,
                                    relu=relu, out_scale=out_scale,
                                    out_qmax=out_qmax)
    _check_operands(x_q, w_q, sw, bias)
    B, H, W, C = x_q.shape
    kh, kw, _, n = w_q.shape
    (ph, pw), (oh, ow) = same_pads(H, W, kh, kw, stride)
    if B * oh * ow * n >= 2 ** 31 or B * H * W * C >= 2 ** 31:
        raise ValueError('depthwise_conv: tensor too large for int32 '
                         'indexing')
    out_int8 = out_scale is not None
    out = torch.empty((B, oh, ow, n), dtype=torch.int8 if out_int8 else
                      torch.float32, device=x_q.device)
    if out.numel() == 0:
        return out
    vec = (n == C and C % 4 == 0 and x_q.data_ptr() % 4 == 0
           and w_q.data_ptr() % 4 == 0)
    rc = _launcher()(
        x_q.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        B, H, W, C, n, kh, kw, stride, ph[0], pw[0], oh, ow,
        float(sx), recip32(out_scale) if out_int8 else 1.0, float(out_qmax),
        int(relu), int(out_int8), int(vec),
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc:
        _build.check(_build.load('depthwise_conv'), rc,
                     'depthwise_conv launch')
    depthwise_conv.launches += 1
    return out


depthwise_conv.launches = 0
