"""W8A8 quantized matmul: the hand-written CUDA kernels
(``csrc/quant_matmul.cu``), their wrapper, launch plan and plain version.

Replaces the reference's Pallas ``quant_matmul`` / ``_qmm_kernel``
(src/repro/kernels/quant_matmul.py): int8 x (M,K) @ int8 w (K,N) into an
int32 accumulator, then ``acc * (sx[m] * sw[n])``, optional bias and ReLU,
and with ``out_scale`` the requantize epilogue that writes int8 on a
static grid.  The reference zero-pads awkward dims to 128; the CUDA kernels
mask (or have TMA zero-fill) their ragged edges instead, so nothing is
padded in device memory.

Both kernels read w K-major (strides (1, K)), as ``export_cnn`` stores
every weight it routes here: the s8 tensor-core operands must be K-major
in shared memory.  A row-major w on a CUDA tensor is copied into that
layout on every call and counted in ``quant_matmul.weight_relayouts``.
Two routes, chosen by :func:`qmm_route` from the operands alone:

* ``'wgmma'`` (K % 16 == 0, x and w 16-byte aligned): TMA + ``wgmma``
  over a ring of K tiles, K split over a thread-block cluster where the
  output has too few tiles (:func:`qmm_plan`).
* ``'mma_sync'`` (the rest: the stem's K = 27, mobilenetv2's K = 24, a
  misaligned operand): the ``mma.sync`` kernel.

:func:`quant_matmul` launches a kernel for a CUDA tensor and runs
:func:`quant_matmul_plain` for a CPU tensor; nothing else decides.
``quant_matmul.launches`` counts kernel launches (and
``quant_matmul.launches_by_route`` by route), ``quant_matmul_plain.calls``
counts plain-version calls, so a run can show which of them served it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, recorded
from repro_torch.kernels.ref import epilogue, int_matmul, recip32
from repro_torch.kernels.tiling import SMEM_BUDGET

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]
_ARGTYPES_WGMMA = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
    [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_LAUNCH = {}         # the bound C entry points, set up on first launch

# The wgmma route's tiles (csrc/quant_matmul.cu): 128 output rows a block
# (two warpgroups of 64), 128 bytes of K a stage, BN 32 or 64 output
# columns; a cluster of up to 4 blocks splits the K tiles of one output
# tile while the grid would otherwise hold fewer than QMM_MIN_BLOCKS blocks.
# Measured on an H100 (scripts/qmm_plan_sweep.py): BN 64 beats 128 at every
# resnet34-cifar stage (twice the tiles, so half the split), and a cluster
# of 8 loses more to its barriers and its 8-way sum than it saves in K.
# The C launcher takes the plans this module makes and no others; the sweep
# builds its own copy with BN 128 and clusters of 8 for that comparison.
QMM_BM = 128
QMM_BK = 128
QMM_MAX_STAGES = 4
QMM_MAX_CLUSTER = 4
QMM_MIN_BLOCKS = 132         # one block for each SM of an H100
QMM_PAD = 8                  # int32 partial tile rows are BN + 8 wide
# An SM's shared memory (228 KB, 1 KB of it reserved a block).  The ring is
# cut until two blocks fit on an SM: one block an SM holds only 15 clusters
# of 8 (30 of 4) at once on an H100, so a split grid of 128 blocks would
# run in two waves (scripts/qmm_plan_sweep.py).
QMM_SM_SMEM = 228 * 1024


def _launcher(name, argtypes):
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = getattr(_build.load('quant_matmul'), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LAUNCH[name] = fn
    return fn


def qmm_smem_bytes(bn: int, stages: int) -> int:
    """Shared memory of a wgmma block (the kernel's ``wg_smem``): 1024
    bytes of alignment slack, the ring of ``stages`` x and w tiles or the
    int32 partial tile laid over it, whichever is larger, the tile's 128
    row scales, its BN column scales and biases, and two mbarriers a
    stage."""
    ring = stages * (QMM_BM + bn) * QMM_BK
    part = QMM_BM * (bn + QMM_PAD) * 4
    return 1024 + max(ring, part) + 4 * (QMM_BM + 2 * bn) + 16 * stages


@functools.lru_cache(maxsize=None)
def qmm_plan(M: int, N: int, K: int):
    """The wgmma route's launch plan: ``(BM, BN, stages, C, smem_bytes)``.
    The grid is C x ceil(N/BN) x ceil(M/BM) blocks; the C blocks of a
    cluster share one output tile and rank r takes K tiles
    :func:`qmm_k_tiles` ``(K, C, r)``."""
    bn = 32 if N <= 32 else 64
    tiles = -(-M // QMM_BM) * -(-N // bn)
    nk = -(-K // QMM_BK)
    c = 1
    while c < QMM_MAX_CLUSTER and 2 * c * tiles <= QMM_MIN_BLOCKS and \
            nk >= 2 * c:
        c *= 2
    stages = max(1, min(QMM_MAX_STAGES, -(-nk // c)))
    while stages > 1 and 2 * (qmm_smem_bytes(bn, stages) + 1024) > \
            QMM_SM_SMEM:
        stages -= 1
    smem = qmm_smem_bytes(bn, stages)
    assert smem <= SMEM_BUDGET
    return QMM_BM, bn, stages, c, smem


def qmm_k_tiles(K: int, C: int, rank: int) -> range:
    """The 128-byte K tiles rank ``rank`` of a C-block cluster sums, as
    the kernel splits them: an even share, every tile once."""
    nk = -(-K // QMM_BK)
    return range(rank * nk // C, (rank + 1) * nk // C)


def quant_matmul_plain(x_q, w_q, sx, sw, bias=None, *, relu=False,
                       out_scale=None, out_qmax=127.0):
    """The kernels' function in plain PyTorch, in the kernels' op order."""
    quant_matmul_plain.calls += 1
    return epilogue(int_matmul(x_q, w_q), sx[:, None] * sw[None, :], bias,
                    relu, out_scale, out_qmax)


quant_matmul_plain.calls = 0


def k_major(w):
    """True when the (K, N) w lies K-major in memory: w[k][n] at
    ``n * K + k`` (strides (1, K)), the layout both kernels read."""
    return w.dim() == 2 and w.t().is_contiguous()


def _check_operands(x_q, w_q, sx, sw, bias):
    """x contiguous; w contiguous or K-major; raises on anything else."""
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f'quant_matmul: x {tuple(x_q.shape)} and w '
                         f'{tuple(w_q.shape)} are not (M,K) and (K,N)')
    M, N = x_q.shape[0], w_q.shape[1]
    if w_q.dtype != torch.int8 or w_q.device != x_q.device or not (
            w_q.is_contiguous() or k_major(w_q)):
        raise ValueError(f'quant_matmul: w must be int8 on x\'s device, '
                         f'row-major or K-major (strides (1, K)), got '
                         f'{w_q.dtype} with strides {w_q.stride()}')
    want = [(x_q, torch.int8, None), (sx, torch.float32, (M,)),
            (sw, torch.float32, (N,))]
    if bias is not None:
        want.append((bias, torch.float32, (N,)))
    _build.check_operands('quant_matmul', x_q.device, want)


def qmm_route(x_q, w_q) -> str:
    """``'wgmma'`` when K % 16 == 0 and x and w start on 16 bytes (TMA's
    rules: every global stride a multiple of 16 bytes), else
    ``'mma_sync'``.  A w that is not K-major counts as aligned: the
    wrapper launches on a fresh K-major copy of it."""
    if x_q.shape[1] % 16 == 0 and x_q.data_ptr() % 16 == 0 and (
            w_q.data_ptr() % 16 == 0 or not k_major(w_q)):
        return 'wgmma'
    return 'mma_sync'


def qmm_call_plan(x_q, w_q, **_):
    """``(route, plan, shared-memory bytes)`` of a call: :func:`qmm_plan`
    on the ``wgmma`` route; the ``mma.sync`` kernel's shared memory is
    static, sized by its compiler."""
    route = qmm_route(x_q, w_q)
    if route != 'wgmma':
        return route, None, None
    plan = qmm_plan(x_q.shape[0], w_q.shape[1], x_q.shape[1])
    return route, plan, plan[-1]


@recorded('quant_matmul', qmm_call_plan)
def quant_matmul(x_q, w_q, sx, sw, bias=None, *, relu=False, out_scale=None,
                 out_qmax=127.0):
    """x_q int8 (M,K) contiguous; w_q int8 (K,N), row-major or K-major; sx
    fp32 (M,); sw fp32 (N,); bias fp32 (N,) or None.  Returns fp32 (M,N),
    or int8 when ``out_scale`` (a static Python float) is set."""
    if not x_q.is_cuda:
        return quant_matmul_plain(x_q, w_q, sx, sw, bias, relu=relu,
                                  out_scale=out_scale, out_qmax=out_qmax)
    _check_operands(x_q, w_q, sx, sw, bias)
    (M, K), N = x_q.shape, w_q.shape[1]
    if M >= 65535 * 64 or M * max(K, N) >= 2 ** 31:
        raise ValueError(f'quant_matmul: M={M} exceeds the launch grid')
    out_int8 = out_scale is not None
    out = torch.empty((M, N), dtype=torch.int8 if out_int8 else
                      torch.float32, device=x_q.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        raise ValueError('quant_matmul: K must be positive')
    if not k_major(w_q):
        w_q = w_q.t().contiguous().t()
        quant_matmul.weight_relayouts += 1
    route = qmm_route(x_q, w_q)
    args = (x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, int(relu), int(out_int8),
            recip32(out_scale) if out_int8 else 1.0, float(out_qmax))
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    if route == 'wgmma':
        rc = _launcher('quant_matmul_wgmma_launch', _ARGTYPES_WGMMA)(
            *args, *qmm_plan(M, N, K), stream)
    else:
        rc = _launcher('quant_matmul_launch', _ARGTYPES)(*args, stream)
    if rc:
        _build.check(_build.load('quant_matmul'), rc,
                     f'quant_matmul launch ({route})')
    quant_matmul.launches += 1
    quant_matmul.launches_by_route[route] += 1
    return out


def reset_route_counts():
    """Zero the wrapper's launches by route and its weight relayouts."""
    quant_matmul.launches_by_route = {'wgmma': 0, 'mma_sync': 0}
    quant_matmul.weight_relayouts = 0


quant_matmul.launches = 0
reset_route_counts()
