"""Fused low-rank conv: the hand-written CUDA kernels
(``csrc/lowrank_conv.cu``), their wrapper, launch plan and plain version,
the fused envelope and the cost model that picks fused against chained.

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

Both kernels read u and v K-major (u (K1, R) with strides (1, K1), v
(R, N) with strides (1, R)), as ``export_cnn`` stores the fused leaves; a
row-major factor on a CUDA tensor is copied into that layout on every call
and counted in ``lowrank_conv.weight_relayouts``.  Two routes, chosen by
:func:`lr_route` from the operands alone:

* ``'wgmma'`` (K1 % 16 == 0, patches, u and v 16-byte aligned: every
  main-path layer): TMA + ``wgmma`` over a ring of K1 tiles, the rank
  padded to the plan's RP, K1 split over a thread-block cluster where the
  M tiles are few (:func:`lr_plan`).
* ``'mma_sync'`` (the rest): the ``mma.sync`` kernel, 32-row tiles.

:func:`lowrank_conv` launches a kernel for a CUDA tensor and runs the
plain version for a CPU tensor; ``lowrank_conv.launches`` (and
``lowrank_conv.launches_by_route``) and ``lowrank_conv_plain.calls``
count each.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, recorded
from repro_torch.kernels.quant_matmul import k_major, qmm_plan
from repro_torch.kernels.ref import lowrank_conv_ref, recip32
from repro_torch.kernels.tiling import SMEM_BUDGET, pad_to

# Serving-cost terms of one NVIDIA H100 SXM for lowering_costs: the dense
# int8 tensor-core peak (1979 TOP/s, so 989.5e6 MACs per microsecond),
# the device memory rate (3.35 TB/s, 3.35e6 bytes per microsecond), and
# the time one kernel wrapper call costs at these sizes, which the chained
# lowering pays twice.  LAUNCH_US is chip_smoke.py's measurement of one
# quant_matmul wrapper call at the head shape on an H100 80GB HBM3 at
# 700 W, in the run it was read from (host time: PERF.md, Findings, gives
# its spread across the runs of chip_smoke on these kernels).
MACS_PER_US = 1979e12 / 2 / 1e6
BYTES_PER_US = 3.35e12 / 1e6
LAUNCH_US = 48.0

# Rank envelope of the fused kernels: the reference's one 128-wide tile.
RANK_TILE = 128

# The wgmma route's tiles (csrc/lowrank_conv.cu): 128 rows of M a block
# (two warpgroups of 64), 128 bytes of K1 a stage, the rank padded to one
# of LR_RPS, the v stage's COUT tiles LR_VNS wide; a cluster of up to 8
# blocks shares one M tile, splits its K1 tiles and its COUT tiles, while
# the grid would otherwise hold fewer than LR_MIN_BLOCKS blocks.  Two
# blocks fit an SM (LR_SM_SMEM, and the kernel's launch bounds cap the
# registers), so a split grid runs in one wave.
LR_BM = 128
LR_BK = 128
LR_RPS = (32, 64, 96, 128)
LR_VNS = (32, 64)
LR_MAX_STAGES = 4
LR_MAX_CLUSTER = 8
LR_MIN_BLOCKS = 132          # one block for each SM of an H100
LR_PAD = 8                   # int32 partial h rows are RP + 8 wide
LR_SM_SMEM = 228 * 1024      # an SM's shared memory, 1 KB a block reserved
LR_MMA_BM = 32               # the mma.sync kernel's M tile

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
    [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGTYPES_WGMMA = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + \
    [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + \
    [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LAUNCH = {}         # the bound C entry points, set up on first launch


def _launcher(name, argtypes):
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = getattr(_build.load('lowrank_conv'), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LAUNCH[name] = fn
    return fn


def fits_fused(r: int, cout: int, *, bm: int = 128) -> bool:
    """Can a factored (u, v) pair of rank ``r`` serve as one launch?

    The reference's envelope, kept as it is so that plan decisions match:
    the lane-padded rank fits one 128-wide tile (``pad_to(r) <= 128``).
    COUT and the M tile do not constrain it."""
    del cout, bm
    return pad_to(r) <= RANK_TILE


def lr_smem_bytes(rp: int, vn: int, stages: int, c: int) -> int:
    """Shared memory of a wgmma block (the kernel's ``lw_smem``): 1024
    bytes of alignment slack; the ring of ``stages`` patches and u tiles,
    or for a split (C > 1) the int32 partial h tile laid over it,
    whichever is larger, rounded up to 1024; the int8 h tile (128 x 128)
    and the v tile (VN x 128); two linear v buffers of VN * RP + 32 bytes;
    the scales (2 RP + 2 VN floats) and two mbarriers a stage."""
    ring = stages * (LR_BM + rp) * LR_BK
    part = LR_BM * (rp + LR_PAD) * 4 if c > 1 else 0
    main = -(-max(ring, part) // 1024) * 1024
    return 1024 + main + LR_BM * 128 + vn * 128 + 2 * (vn * rp + 32) + \
        4 * (2 * rp + 2 * vn) + 16 * stages


@functools.lru_cache(maxsize=None)
def lr_plan(M: int, K1: int, R: int, N: int):
    """The wgmma route's launch plan: ``(BM, RP, VN, stages, C,
    smem_bytes)``.  The grid is C x ceil(M/BM) blocks; the C blocks of a
    cluster share one M tile, rank r sums K1 tiles :func:`lr_k_tiles`
    ``(K1, C, r)``, requantizes rows :func:`lr_h_rows` ``(C, r)`` of h for
    the whole cluster and computes COUT tiles :func:`lr_n_tiles` ``(N, VN,
    C, r)``.  The cluster doubles while the grid stays within
    LR_MIN_BLOCKS and every rank keeps at least 64 COUT columns (measured
    on an H100, scripts/lr_plan_sweep.py: at resnet34-cifar's stage 2,
    clusters of 4 with 64-column v tiles beat clusters of 8 with 32-column
    ones by 8-13%)."""
    rp = next(p for p in LR_RPS if p >= R)
    tiles = -(-M // LR_BM)
    nk = -(-K1 // LR_BK)
    c = 1
    while c < LR_MAX_CLUSTER and 2 * c * tiles <= LR_MIN_BLOCKS and \
            N >= 128 * c:
        c *= 2
    vn = LR_VNS[0] if -(-N // c) <= LR_VNS[0] else LR_VNS[1]
    stages = max(1, min(LR_MAX_STAGES, -(-nk // c)))
    while stages > 1 and 2 * (lr_smem_bytes(rp, vn, stages, c) + 1024) > \
            LR_SM_SMEM:
        stages -= 1
    smem = lr_smem_bytes(rp, vn, stages, c)
    assert smem <= SMEM_BUDGET
    return LR_BM, rp, vn, stages, c, smem


def lr_k_tiles(K1: int, C: int, rank: int) -> range:
    """The 128-byte K1 tiles rank ``rank`` of a C-block cluster sums: an
    even share, every tile once (a rank may have none)."""
    nk = -(-K1 // LR_BK)
    return range(rank * nk // C, (rank + 1) * nk // C)


def lr_h_rows(C: int, rank: int) -> range:
    """The rows of the 128-row h tile rank ``rank`` sums and requantizes
    for the whole cluster."""
    return range(rank * LR_BM // C, (rank + 1) * LR_BM // C)


def lr_n_tiles(N: int, VN: int, C: int, rank: int) -> range:
    """The VN-wide COUT tiles of the v stage rank ``rank`` computes."""
    nt = -(-N // VN)
    return range(rank * nt // C, (rank + 1) * nt // C)


def lowering_costs(m: int, k1: int, r: int, n: int, *,
                   launch_us: float = LAUNCH_US) -> dict:
    """Modeled time (us) of one factored conv served fused or chained on
    an H100, from this port's kernels' traffic.

    Both lowerings read the patches (M x K1 int8) once and write the int8
    output (M x N) once; u and v are read once (a few hundred KB, they stay
    in the 50 MB L2 across M tiles).  The chained pair also writes h (M x R
    int8) and reads it back, and pays a second launch.  MACs are those the
    tensor cores run: the fused kernel pads the rank to its plan's RP
    (:func:`lr_plan`), the chained launches pad it to ``quant_matmul``'s
    BN (``qmm_plan``) for u and to 64 for v.  Each launch costs
    ``launch_us`` plus the larger of its compute and byte times.  Used by
    ``core/export.py`` with ``select_kernels='model'``."""
    rp_f = lr_plan(m, k1, r, n)[1]
    rp_c = pad_to(r, qmm_plan(m, r, k1)[1])
    fused_macs = m * rp_f * (k1 + n)
    fused_bytes = m * k1 + k1 * r + r * n + m * n
    bytes_u = m * k1 + k1 * r + m * r
    bytes_v = m * r + r * n + m * n
    fused_us = launch_us + max(fused_macs / MACS_PER_US,
                               fused_bytes / BYTES_PER_US)
    chained_us = (2 * launch_us
                  + max(m * rp_c * k1 / MACS_PER_US, bytes_u / BYTES_PER_US)
                  + max(m * pad_to(r, 64) * n / MACS_PER_US,
                        bytes_v / BYTES_PER_US))
    return {'fused_us': fused_us, 'chained_us': chained_us,
            'fused_bytes': fused_bytes, 'chained_bytes': bytes_u + bytes_v,
            'fused_macs': fused_macs, 'macs': m * r * (k1 + n)}


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
    """patches contiguous; u and v int8 on its device, each row-major or
    K-major; raises on anything else."""
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
    for name, w in (('u', u_q), ('v', v_q)):
        if w.dtype != torch.int8 or w.device != patches.device or not (
                w.is_contiguous() or k_major(w)):
            raise ValueError(f'lowrank_conv: {name} must be int8 on the '
                             f'patches\' device, row-major or K-major '
                             f'(strides (1, K)), got {w.dtype} with strides '
                             f'{w.stride()}')
    want = [(patches, torch.int8, None), (su, torch.float32, (r,)),
            (bu, torch.float32, (r,)), (sv, torch.float32, (n,)),
            (bv, torch.float32, (n,))]
    _build.check_operands('lowrank_conv', patches.device, want)


def lr_route(patches, u_q, v_q) -> str:
    """``'wgmma'`` when K1 % 16 == 0 and patches, u and v start on 16
    bytes (TMA's rules for the patches and u, 16-byte copies for v), else
    ``'mma_sync'``.  A factor that is not K-major counts as aligned: the
    wrapper launches on a fresh K-major copy of it."""
    if patches.shape[1] % 16 == 0 and patches.data_ptr() % 16 == 0 and \
            all(w.data_ptr() % 16 == 0 or not k_major(w) for w in (u_q, v_q)):
        return 'wgmma'
    return 'mma_sync'


def lr_call_plan(patches, u_q, v_q, **_):
    """``(route, plan, shared-memory bytes)`` of a call: :func:`lr_plan`
    on the ``wgmma`` route (inside the fused envelope); the ``mma.sync``
    kernel's shared memory is static, sized by its compiler."""
    route = lr_route(patches, u_q, v_q)
    (M, K1), (R, N) = patches.shape, v_q.shape
    if route != 'wgmma' or not fits_fused(R, N):
        return route, None, None
    plan = lr_plan(M, K1, R, N)
    return route, plan, plan[-1]


@recorded('lowrank_conv', lr_call_plan)
def lowrank_conv(patches, u_q, v_q, su, sv, bu, bv, *, sx, h_scale,
                 relu=False, out_scale=None, h_qmax=127.0, out_qmax=127.0):
    """patches int8 (M,K1) contiguous; u_q int8 (K1,R) and v_q int8 (R,N),
    each row-major or K-major; su/bu fp32 (R,); sv/bv fp32 (N,) (zeros
    where a half has no bias); ``sx``, ``h_scale`` and ``out_scale``
    static Python floats.  Returns fp32 (M,N), or int8 when ``out_scale``
    is set."""
    if not patches.is_cuda:
        return lowrank_conv_plain(patches, u_q, v_q, su, sv, bu, bv, sx=sx,
                                  h_scale=h_scale, relu=relu,
                                  out_scale=out_scale, h_qmax=h_qmax,
                                  out_qmax=out_qmax)
    _check_operands(patches, u_q, v_q, su, sv, bu, bv)
    (M, K1), (R, N) = patches.shape, v_q.shape
    if M * max(K1, N) >= 2 ** 31 or -(-M // LR_BM) > 65535:
        raise ValueError(f'lowrank_conv: M={M} too large for the launch '
                         f'grid or int32 indexing')
    out_int8 = out_scale is not None
    out = torch.empty((M, N), dtype=torch.int8 if out_int8 else
                      torch.float32, device=patches.device)
    if M == 0 or N == 0:
        return out
    if K1 == 0:
        raise ValueError('lowrank_conv: K1 must be positive')
    if not k_major(u_q):
        u_q = u_q.t().contiguous().t()
        lowrank_conv.weight_relayouts += 1
    if not k_major(v_q):
        v_q = v_q.t().contiguous().t()
        lowrank_conv.weight_relayouts += 1
    route = lr_route(patches, u_q, v_q)
    args = (patches.data_ptr(), u_q.data_ptr(), v_q.data_ptr(),
            su.data_ptr(), bu.data_ptr(), sv.data_ptr(), bv.data_ptr(),
            out.data_ptr(), M, K1, R, N, float(sx), float(h_scale),
            recip32(h_scale), float(h_qmax), int(relu), int(out_int8),
            recip32(out_scale) if out_int8 else 1.0, float(out_qmax))
    stream = torch.cuda.current_stream(patches.device).cuda_stream
    if route == 'wgmma':
        rc = _launcher('lowrank_conv_wgmma_launch', _ARGTYPES_WGMMA)(
            *args, *lr_plan(M, K1, R, N), stream)
    else:
        aligned = K1 % 16 == 0
        rc = _launcher('lowrank_conv_launch', _ARGTYPES)(
            *args, int(aligned and patches.data_ptr() % 16 == 0),
            int(aligned and u_q.data_ptr() % 16 == 0),
            int(R % 16 == 0 and v_q.data_ptr() % 16 == 0), stream)
    if rc:
        _build.check(_build.load('lowrank_conv'), rc,
                     f'lowrank_conv launch ({route})')
    lowrank_conv.launches += 1
    lowrank_conv.launches_by_route[route] += 1
    return out


def reset_route_counts():
    """Zero the wrapper's launches by route and its weight relayouts."""
    lowrank_conv.launches_by_route = {'wgmma': 0, 'mma_sync': 0}
    lowrank_conv.weight_relayouts = 0


lowrank_conv.launches = 0
reset_route_counts()
