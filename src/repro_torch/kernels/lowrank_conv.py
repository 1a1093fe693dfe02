"""Fused low-rank conv: the hand-written CUDA kernel
(``csrc/lowrank_conv.cu``), its wrapper, its plain version, the fused
envelope and the cost model that picks fused against chained.

Replaces the reference's Pallas ``lowrank_conv`` / ``_lr_kernel``
(src/repro/kernels/lowrank_conv.py): a factored conv pair (u: a spatial
conv down to rank R, v: a 1x1 conv back up to COUT) served as one launch
on the im2col patches (M, K1):

    patches @ u -> acc * (sx * su) + bu -> int8 h on the static h_scale
    h @ v       -> acc * (h_scale * sv) + bv (ReLU) (requantize)

h never leaves the chip, and the launch is bit-exact with the chained
pair of ``quant_matmul`` launches (u with ``out_scale=h_scale``, then v):
:func:`lowrank_conv_plain` is that chained pair on the int path.  The
im2col gather stays in PyTorch (``ops.lowrank_conv_nhwc``), as for
``quant_conv``.

:func:`lowrank_conv` launches the kernel for a CUDA tensor and runs the
plain version for a CPU tensor; ``lowrank_conv.launches`` and
``lowrank_conv_plain.calls`` count each.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lowrank_conv_ref, recip32
from repro_torch.kernels.tiling import pad_to

# Serving-cost terms of one NVIDIA H100 SXM for lowering_costs: the dense
# int8 tensor-core peak (1979 TOP/s, so 989.5e6 MACs per microsecond),
# the device memory rate (3.35 TB/s, 3.35e6 bytes per microsecond), and
# the time one kernel wrapper call costs at these sizes, which the chained
# lowering pays twice.  LAUNCH_US is chip_smoke.py's measurement of one
# 32-row quant_matmul wrapper call on an H100 80GB HBM3 at 700 W (PERF.md).
MACS_PER_US = 1979e12 / 2 / 1e6
BYTES_PER_US = 3.35e12 / 1e6
LAUNCH_US = 31.3

# Rank tile of the fused kernel (csrc/lowrank_conv.cu RP).
RANK_TILE = 128

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
    [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]
_LAUNCH = []         # the bound C entry point, set up on first launch


def _launcher():
    if not _LAUNCH:
        fn = _build.load('lowrank_conv').lowrank_conv_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def fits_fused(r: int, cout: int, *, bm: int = 128) -> bool:
    """Can a factored (u, v) pair of rank ``r`` serve as one launch?

    The reference's envelope, kept as it is so that plan decisions match:
    the lane-padded rank fits one 128-wide tile (``pad_to(r) <= 128``).
    COUT and the M tile do not constrain it."""
    del cout, bm
    return pad_to(r) <= RANK_TILE


def lowering_costs(m: int, k1: int, r: int, n: int, *,
                   launch_us: float = LAUNCH_US) -> dict:
    """Modeled time (us) of one factored conv served fused or chained on
    an H100, from this port's kernels' traffic.

    Both lowerings read the patches (M x K1 int8) once and write the int8
    output (M x N) once; u and v are read once (a few hundred KB, they stay
    in the 50 MB L2 across M tiles).  The chained pair also writes h (M x R
    int8) and reads it back, and pays a second launch.  MACs are those the
    tensor cores run: the fused kernel pads the rank to its 128 tile, the
    chained launches pad it to quant_matmul's 64-wide tiles.  Each launch
    costs ``launch_us`` plus the larger of its compute and byte times.
    Used by ``core/export.py`` with ``select_kernels='model'``."""
    rp_f, rp_c = RANK_TILE, pad_to(r, 64)
    fused_macs = m * rp_f * (k1 + n)
    fused_bytes = m * k1 + k1 * r + r * n + m * n
    bytes_u = m * k1 + k1 * r + m * r
    bytes_v = m * r + r * n + m * n
    fused_us = launch_us + max(fused_macs / MACS_PER_US,
                               fused_bytes / BYTES_PER_US)
    chained_us = (2 * launch_us
                  + max(m * rp_c * k1 / MACS_PER_US, bytes_u / BYTES_PER_US)
                  + max(m * rp_c * n / MACS_PER_US, bytes_v / BYTES_PER_US))
    return {'fused_us': fused_us, 'chained_us': chained_us,
            'fused_bytes': fused_bytes, 'chained_bytes': bytes_u + bytes_v,
            'macs': m * r * (k1 + n)}


def pick_bm(m: int) -> int:
    """M-tile height of the fused kernel: 32 rows when 64-row tiles would
    give at most 32 blocks (M <= 2048), else 64.  Measured on an H100 at
    the main path's shapes (PERF.md): 32-row tiles take 2-28% less time
    at M <= 2048, the two are within 8% at M = 8192, and 64-row tiles
    take 38% less time at M = 32768."""
    return 32 if m <= 2048 else 64


def lowrank_conv_plain(patches, u_q, v_q, su, sv, bu, bv, *, sx, h_scale,
                       relu=False, out_scale=None, h_qmax=127.0,
                       out_qmax=127.0):
    """The kernel's function in plain PyTorch: the chained pair."""
    lowrank_conv_plain.calls += 1
    return lowrank_conv_ref(patches, u_q, v_q, su, sv, bu, bv, sx=sx,
                            h_scale=h_scale, relu=relu, out_scale=out_scale,
                            h_qmax=h_qmax, out_qmax=out_qmax)


lowrank_conv_plain.calls = 0


def _check_operands(patches, u_q, v_q, su, sv, bu, bv):
    if patches.dim() != 2 or u_q.dim() != 2 or v_q.dim() != 2 \
            or patches.shape[1] != u_q.shape[0] \
            or u_q.shape[1] != v_q.shape[0]:
        raise ValueError(f'lowrank_conv: patches {tuple(patches.shape)}, u '
                         f'{tuple(u_q.shape)} and v {tuple(v_q.shape)} are '
                         f'not (M,K1), (K1,R) and (R,N)')
    r, n = v_q.shape
    if not fits_fused(r, n):
        raise ValueError(f'lowrank_conv: rank {r} exceeds the fused '
                         f'envelope ({RANK_TILE}); chain instead')
    want = [(patches, torch.int8, None), (u_q, torch.int8, None),
            (v_q, torch.int8, None), (su, torch.float32, (r,)),
            (bu, torch.float32, (r,)), (sv, torch.float32, (n,)),
            (bv, torch.float32, (n,))]
    _build.check_operands('lowrank_conv', patches.device, want)


def lowrank_conv(patches, u_q, v_q, su, sv, bu, bv, *, sx, h_scale,
                 relu=False, out_scale=None, h_qmax=127.0, out_qmax=127.0,
                 _bm=None):
    """patches int8 (M,K1); u_q int8 (K1,R); v_q int8 (R,N); su/bu fp32
    (R,); sv/bv fp32 (N,) (zeros where a half has no bias); ``sx``,
    ``h_scale`` and ``out_scale`` static Python floats.  Returns fp32
    (M,N), or int8 when ``out_scale`` is set.  The kernel's M tile comes
    from M (:func:`pick_bm`); ``_bm`` (32 or 64) overrides it, for the
    tile measurement in chip_smoke.py and the tests only."""
    if not patches.is_cuda:
        return lowrank_conv_plain(patches, u_q, v_q, su, sv, bu, bv, sx=sx,
                                  h_scale=h_scale, relu=relu,
                                  out_scale=out_scale, h_qmax=h_qmax,
                                  out_qmax=out_qmax)
    _check_operands(patches, u_q, v_q, su, sv, bu, bv)
    (M, K1), (R, N) = patches.shape, v_q.shape
    if M * max(K1, N) >= 2 ** 31:
        raise ValueError(f'lowrank_conv: M={M} too large for int32 '
                         f'indexing')
    out_int8 = out_scale is not None
    out = torch.empty((M, N), dtype=torch.int8 if out_int8 else
                      torch.float32, device=patches.device)
    if M == 0 or N == 0:
        return out
    if K1 == 0:
        raise ValueError('lowrank_conv: K1 must be positive')
    bm = pick_bm(M) if _bm is None else _bm
    if bm not in (32, 64):
        raise ValueError(f'lowrank_conv: _bm must be 32 or 64, got {bm}')
    rc = _launcher()(
        patches.data_ptr(), u_q.data_ptr(), v_q.data_ptr(), su.data_ptr(),
        bu.data_ptr(), sv.data_ptr(), bv.data_ptr(), out.data_ptr(),
        M, K1, R, N, float(sx), float(h_scale), recip32(h_scale),
        float(h_qmax), int(relu), int(out_int8),
        recip32(out_scale) if out_int8 else 1.0, float(out_qmax),
        int(K1 % 16 == 0 and patches.data_ptr() % 16 == 0),
        int(u_q.data_ptr() % 16 == 0),
        int(N % 4 == 0 and v_q.data_ptr() % 4 == 0), int(bm),
        torch.cuda.current_stream(patches.device).cuda_stream)
    if rc:
        _build.check(_build.load('lowrank_conv'), rc, 'lowrank_conv launch')
    lowrank_conv.launches += 1
    return out


lowrank_conv.launches = 0
