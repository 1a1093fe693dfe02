"""Int8 depthwise conv: the hand-written CUDA kernels
(``csrc/depthwise_conv.cu``), their wrapper, launch plan and plain version.

Replaces the reference's Pallas ``depthwise_conv`` / ``_dw_kernel``
(src/repro/kernels/depthwise_conv.py): a direct SAME conv with per-group
input depth 1, int32 multiply-accumulates over the KH x KW taps on the raw
int8 codes, then the epilogue shared with ``quant_matmul``
(``acc * (sx * sw[o])``, bias, ReLU, optional static requantize to int8).
A channel multiplier reads input channel ``o // (COUT // CIN)`` for output
channel ``o``.  The reference pads the plane and the channels to 128 and
repeats the input for a multiplier; the CUDA kernels take the SAME border
from TMA's zero fill or mask it, and index the multiplier, so nothing is
padded or copied in device memory.  Two routes, chosen by
:func:`dw_route`:

* ``'tile'`` (3x3, stride 1 or 2, CIN and COUT multiples of 16, a
  multiplier of 1 or 2, x and w 16-byte aligned: every mobilenetv2-cifar
  layer): a block stages a band's halo tile in shared memory with one TMA
  load and each thread slides a register window along a run of output
  columns for one 16-byte group of channels (:func:`dw_plan`).
* ``'general'`` (the rest): one thread per four channels of an output
  pixel.

:func:`depthwise_conv` launches a kernel for a CUDA tensor and runs
:func:`depthwise_conv_plain` for a CPU tensor; ``depthwise_conv.launches``
(and ``depthwise_conv.launches_by_route``) and
``depthwise_conv_plain.calls`` count each.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, recorded
from repro_torch.kernels.ref import depthwise_conv_ref, recip32, same_pads
from repro_torch.kernels.tiling import SMEM_BUDGET

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + \
    [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGTYPES_TILE = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
    [ctypes.c_float] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_LAUNCH = {}         # the bound C entry points, set up on first launch

# The tile route (csrc/depthwise_conv.cu, dw_tile_kernel): a thread owns
# one 16-byte group of 16 output channels of a run of DW_COLS output
# columns; a block's slice is at most DW_MAX_GROUPS groups (128 channels)
# and it holds at most DW_MAX_THREADS threads; a TMA box dimension is at
# most DW_MAX_BOX.  dw_plan takes runs of 4 columns where the grid then
# keeps DW_WANT_THREADS threads (two warps for each scheduler of the 132
# SMs), else 2, and the tallest band that keeps DW_MIN_BLOCKS blocks.
# Measured on an H100 (scripts/dw_plan_sweep.py, mobilenetv2-cifar's eight
# shapes): runs of 8 never beat 4, and below stage 0 runs of 2 beat 4 by
# 10-20% (the layers are too small to fill the card otherwise); blocks of
# 96-192 threads beat shorter bands with more blocks by up to 15%, even
# where the grid then holds 96-128 blocks, under one wave; and a box
# widened past the columns the runs need, to a row pitch free of bank
# conflicts, was no faster.
DW_MAX_GROUPS = 8
DW_COLS = (2, 4)             # the runs the kernel is built for
DW_MAX_THREADS = 256
DW_WANT_THREADS = 132 * 4 * 2 * 32
DW_MIN_BLOCKS = 96
DW_MAX_BOX = 256
DW_MULTS = (1, 2)
DW_TILE_ALIGN = 128          # TMA's shared-memory destination alignment
DW_THREADS = 256             # the general kernel's block


class DwPlan(NamedTuple):
    """A launch plan.  ``route`` 'tile': a block covers ``slice`` output
    channels (whole 16-byte groups) of ``rows`` output rows of one image,
    a thread 16 channels of ``cols`` output columns of one row; ``box`` is
    the halo tile (bytes of input channels, columns, rows) one TMA load
    stages.  ``route`` 'general': a thread
    covers 4 channels of one output pixel (slice 4, rows and cols 1)."""
    route: str
    slice: int
    rows: int
    cols: int
    threads: int
    smem_bytes: int
    grid: tuple
    box: tuple


def _launcher(name, argtypes):
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = getattr(_build.load('depthwise_conv'), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LAUNCH[name] = fn
    return fn


def fits_depthwise(w_shape) -> bool:
    """Can this grouped conv serve on the depthwise kernel?  True for
    per-group input depth 1 (HWIO weight ``(KH, KW, 1, COUT)``): plain
    depthwise and channel-multiplier variants.  The same test as the
    reference's, so plan decisions match."""
    return len(w_shape) == 4 and w_shape[2] == 1


def dw_tile_fits(C: int, N: int, KH: int, KW: int, stride: int) -> bool:
    """Shapes the tile kernel is built for: 3x3, stride 1 or 2, CIN and
    COUT multiples of 16, COUT = CIN or 2 CIN."""
    return (KH, KW) == (3, 3) and stride in (1, 2) and C > 0 and \
        C % 16 == 0 and N % 16 == 0 and N % C == 0 and N // C in DW_MULTS


def dw_smem_bytes(box_c: int, box_w: int, box_h: int) -> int:
    """Shared memory of a tile block (the kernel's ``tile_smem``): the
    alignment slack, the tile rounded up to 16 bytes, the mbarrier."""
    return DW_TILE_ALIGN + -(-box_c * box_w * box_h // 16) * 16 + 16


def dw_tile_plan(B: int, H: int, W: int, C: int, N: int, stride: int, *,
                 groups: int, cols: int, rows: int):
    """The tile route's plan for a given slice (``groups`` 16-byte
    groups), run and band, or None where it does not fit the kernel.  The
    box holds the band's rows plus the 2 halo rows and every column the
    runs reach."""
    mult = N // C
    (_, _), (oh, ow) = same_pads(H, W, 3, 3, stride)
    runs = -(-ow // cols)
    threads = groups * rows * runs
    if groups % mult or groups > DW_MAX_GROUPS or cols not in DW_COLS or \
            threads > DW_MAX_THREADS:
        return None
    box = (groups * 16 // mult, (runs * cols - 1) * stride + 3,
           (rows - 1) * stride + 3)
    smem = dw_smem_bytes(*box)
    if max(box[1:]) > DW_MAX_BOX or smem > SMEM_BUDGET or \
            -(-oh // rows) > 65535 or B > 65535:
        return None
    return DwPlan('tile', 16 * groups, rows, cols, threads, smem,
                  (-(-N // (16 * groups)), -(-oh // rows), B), box)


def _general_plan(B, oh, ow, N):
    quads = B * oh * ow * -(-N // 4)
    return DwPlan('general', 4, 1, 1, DW_THREADS, 0,
                  (-(-quads // DW_THREADS), 1, 1), (0, 0, 0))


@functools.lru_cache(maxsize=None)
def dw_plan(B: int, H: int, W: int, C: int, N: int, KH: int, KW: int,
            stride: int) -> DwPlan:
    """The launch plan for x (B,H,W,C) and w (KH,KW,1,N) at ``stride``:
    the tile route where :func:`dw_tile_fits` and the plan fits, else the
    general route.

    The tile plan: the slice is the most whole 16-byte groups, at most 8
    (128 channels), that divide COUT's groups evenly (mobilenetv2-cifar's
    96, 144, 192 and 384 give 96, 48, 96 and 128), so no lane idles on a
    ragged slice; runs of 4 output columns where the grid keeps
    DW_WANT_THREADS threads, else 2; the tallest band of at most
    DW_MAX_THREADS threads that keeps DW_MIN_BLOCKS blocks (one row where
    none does)."""
    (_, _), (oh, ow) = same_pads(H, W, KH, KW, stride)
    if not dw_tile_fits(C, N, KH, KW, stride):
        return _general_plan(B, oh, ow, N)
    mult = N // C
    g_all = N // 16
    groups = max(d for d in range(1, DW_MAX_GROUPS + 1)
                 if g_all % d == 0 and d % mult == 0)
    cols = 4 if B * oh * -(-ow // 4) * g_all >= DW_WANT_THREADS else 2
    lanes = groups * -(-ow // cols)
    slices = g_all // groups
    rows = 1
    while rows < oh and lanes * 2 * rows <= DW_MAX_THREADS and \
            slices * B * -(-oh // (2 * rows)) >= DW_MIN_BLOCKS:
        rows *= 2
    plan = dw_tile_plan(B, H, W, C, N, stride, groups=groups, cols=cols,
                        rows=rows)
    return plan if plan is not None else _general_plan(B, oh, ow, N)


def dw_route(x_q, w_q, stride, out_scale=None, out_qmax=127.0) -> str:
    """``'tile'`` where the plan takes the tile route, x and w start on
    16 bytes and an int8 output has a positive scale and a whole-number
    qmax up to 127 (its clip then commutes with the rounding, and takes
    the ReLU as its lower bound), else ``'general'``."""
    B, H, W, C = x_q.shape
    kh, kw, _, n = w_q.shape
    if dw_plan(B, H, W, C, n, kh, kw, stride).route == 'tile' and \
            x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0 and (
                out_scale is None or (out_scale > 0 and
                                      float(out_qmax).is_integer() and
                                      0 <= out_qmax <= 127)):
        return 'tile'
    return 'general'


def dw_call_plan(x_q, w_q, stride, out_scale, out_qmax, **_):
    """``(route, plan, shared-memory bytes)`` of a call: :func:`dw_plan`
    on the tile route, the general kernel's plan (no shared memory)
    else."""
    B, H, W, C = x_q.shape
    kh, kw, _, n = w_q.shape
    route = dw_route(x_q, w_q, stride, out_scale, out_qmax)
    if route == 'tile':
        plan = dw_plan(B, H, W, C, n, kh, kw, stride)
    else:
        (_, _), (oh, ow) = same_pads(H, W, kh, kw, stride)
        plan = _general_plan(B, oh, ow, n)
    return route, plan, plan.smem_bytes


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


@recorded('depthwise_conv', dw_call_plan)
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
    route = dw_route(x_q, w_q, stride, out_scale, out_qmax)
    args = (x_q.data_ptr(), w_q.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, C, n)
    epi = (float(sx), recip32(out_scale) if out_int8 else 1.0,
           float(out_qmax), int(relu), int(out_int8))
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    if route == 'tile':
        p = dw_plan(B, H, W, C, n, kh, kw, stride)
        rc = _launcher('depthwise_conv_tile_launch', _ARGTYPES_TILE)(
            *args, stride, ph[0], pw[0], oh, ow, *epi, p.slice // 16,
            p.rows, p.cols, p.threads, p.box[1], p.box[2], p.smem_bytes,
            stream)
    else:
        vec = (n == C and C % 4 == 0 and x_q.data_ptr() % 4 == 0
               and w_q.data_ptr() % 4 == 0)
        rc = _launcher('depthwise_conv_launch', _ARGTYPES)(
            *args, kh, kw, stride, ph[0], pw[0], oh, ow, *epi, int(vec),
            stream)
    if rc:
        _build.check(_build.load('depthwise_conv'), rc,
                     f'depthwise_conv launch ({route})')
    depthwise_conv.launches += 1
    depthwise_conv.launches_by_route[route] += 1
    return out


def reset_route_counts():
    """Zero the wrapper's launches by route."""
    depthwise_conv.launches_by_route = {'tile': 0, 'general': 0}


depthwise_conv.launches = 0
reset_route_counts()
