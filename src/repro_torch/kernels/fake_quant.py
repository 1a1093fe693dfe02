"""Per-channel fake quantization: a CUDA kernel over thread-block clusters
and a Triton pair, behind two wrappers, and their plain versions.

For a 2-D weight w (K, N), each column gets ``scale = max(amax, 1e-8) /
qmax`` from its abs-max, and the output is ``clip(round(w / scale),
-qmax-1, qmax) * scale``.  The weight is read as fp32 (fp32 or bf16 in
device memory), the arithmetic is fp32, and the output is written in w's
dtype, rounded to nearest even: the reference's kernels upcast, quantize
and cast back the same way.

* :func:`fake_quant_fused` replaces the reference's ``fake_quant_fused`` /
  ``_fused_kernel`` (src/repro/kernels/fake_quant.py) with the CUDA kernel
  in ``csrc/fake_quant.cu``.  The Pallas kernel holds a whole (K, bn)
  column stripe in VMEM; here a cluster of C blocks splits a BN-column
  stripe along K, each block stages its (R, BN) slice in shared memory,
  and the blocks exchange their column maxima through distributed shared
  memory before each quantizes its own slice: one launch, w read from
  device memory once.  :func:`fused_plan` picks (BN, C, R) so that the
  grid fills the card; the CPU tests check the same plan the card runs.
* :func:`fake_quant` replaces the reference's two-pass ``fake_quant`` /
  ``_amax_kernel`` + ``_quant_kernel``, which the reference takes when a
  (K, 256) fp32 stripe overflows its VMEM budget (kernels/ops.py routes
  the same way).  Here ``_amax_kernel`` runs one Triton program per (BK,
  BN) tile and merges its column maxima into a zeroed fp32 (N,) buffer
  with ``atomic_max`` (|w| >= 0, and a max does not depend on the order
  of its terms, so the result is deterministic); ``_quant_kernel`` then
  quantizes one (BK, BN) tile per program.  The wrapper counts one launch
  for the pair.

All are elementwise passes and a column reduction with no product for the
tensor cores: they are bound by bytes (read w, write the output).  Ragged
edges are masked; nothing is padded in device memory.

Numerics match the plain versions bit for bit: the scale multiplies by the
fp32 reciprocal of qmax (as the reference's compiled kernels do), the
division ``w / scale`` is IEEE-rounded (``__fdiv_rn`` in CUDA, ``div_rn``
in Triton, which may otherwise lower an fp32 ``/`` to an approximate
division), rounding is half to even (``rint``), and the store's fp32 ->
bf16 cast rounds to nearest even.

``triton`` is imported on the first launch of the pair, never when this
module is imported: hosts without a card have no triton.  Its kernel
bodies read ``tl``, ``libdevice`` and ``_quantize`` as module globals bound
at that point; their annotations stay strings (``from __future__ import
annotations``), which Triton reads as constexpr markers.  The CUDA library
is built on its first launch too (kernels/_build.py).
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fake_quant_ref, recip32
from repro_torch.kernels.tiling import SMEM_BUDGET

tl = None            # triton.language, bound by _jit()
libdevice = None     # triton.language.extra.libdevice, bound by _jit()
_quantize = None     # triton.jit(_quantize_body), bound by _jit()
_KERNELS = {}

TILE_K, TILE_N = 64, 128     # the two-pass kernels' tile (128 columns a row)

# The fused kernel's launch plan (csrc/fake_quant.cu).  A stripe is BN
# columns wide and a cluster of C blocks splits it along K; BN is a power
# of two from 16 to 128 (the kernel's 256 threads split a stripe row
# evenly) and C stays within the portable cluster size of 8.
FUSED_BNS = (128, 64, 32, 16)
FUSED_CLUSTERS = (1, 2, 4, 8)
FUSED_MIN_BLOCKS = 132       # one block for each SM of an H100
STATIC_SMEM = 48 * 1024      # above this a block needs the opt-in attribute

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]
_LAUNCH = []         # the bound C entry point, set up on first launch


def _quantize_body(w, scale, qmax):
    """``clip(rint(w / scale), -qmax-1, qmax) * scale`` on an fp32 tile,
    one scale per column."""
    q = libdevice.rint(tl.math.div_rn(w, scale[None, :]))
    q = tl.minimum(tl.maximum(q, -qmax - 1.0), qmax)
    return q * scale[None, :]


def _amax_kernel(w_ptr, amax_ptr, K, N, BK: tl.constexpr, BN: tl.constexpr):
    rows = tl.program_id(0) * BK + tl.arange(0, BK)
    cols = tl.program_id(1) * BN + tl.arange(0, BN)
    cmask = cols < N
    mask = (rows[:, None] < K) & cmask[None, :]
    w = tl.load(w_ptr + rows[:, None] * N + cols[None, :], mask=mask,
                other=0.0).to(tl.float32)
    tl.atomic_max(amax_ptr + cols, tl.max(tl.abs(w), axis=0), mask=cmask,
                  sem='relaxed')


def _quant_kernel(w_ptr, amax_ptr, o_ptr, K, N, qmax, inv_qmax,
                  BK: tl.constexpr, BN: tl.constexpr):
    rows = tl.program_id(0) * BK + tl.arange(0, BK)
    cols = tl.program_id(1) * BN + tl.arange(0, BN)
    cmask = cols < N
    amax = tl.load(amax_ptr + cols, mask=cmask, other=0.0)
    scale = tl.maximum(amax, 1e-8) * inv_qmax
    mask = (rows[:, None] < K) & cmask[None, :]
    offs = rows[:, None] * N + cols[None, :]
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + offs,
             _quantize(w, scale, qmax).to(o_ptr.dtype.element_ty), mask=mask)


def _jit():
    """Import triton and wrap the kernel bodies, once per process."""
    global tl, libdevice, _quantize
    if not _KERNELS:
        os.environ.setdefault('TRITON_CACHE_DIR',
                              str(_build.BUILD_ROOT / 'triton'))
        import triton
        import triton.language
        from triton.language.extra import libdevice as _libdevice
        tl, libdevice = triton.language, _libdevice
        _quantize = triton.jit(_quantize_body)
        for fn in (_amax_kernel, _quant_kernel):
            _KERNELS[fn.__name__] = triton.jit(fn)
    return _KERNELS


def fused_plan(K: int, N: int, elem_bytes: int):
    """Launch plan of the fused kernel for a (K, N) weight of ``elem_bytes``
    bytes an element: ``(BN, C, R, smem_bytes, staged)``.

    Block r of a cluster owns rows [r*R, min((r+1)*R, K)) of a BN-column
    stripe; the grid is (ceil(N / BN), C).  Among the slices that fit
    without the opt-in shared memory, then among those that fit
    ``SMEM_BUDGET``, the widest stripe on the smallest cluster that runs
    ``FUSED_MIN_BLOCKS`` blocks wins, else the plan with the most blocks
    (small slices also let several blocks share an SM, so one block's
    loads overlap another's stores).  Where no slice fits (a very tall,
    narrow weight), ``staged`` is False: 16-column stripes on clusters of
    8, each block walking its rows twice from device memory."""
    def need(bn, r, staged):
        return 8 * bn + (r * bn * elem_bytes if staged else 0)

    for limit in (STATIC_SMEM, SMEM_BUDGET):
        best = None
        for bn in FUSED_BNS:
            for c in FUSED_CLUSTERS:
                r = -(-K // c)
                if need(bn, r, True) > limit:
                    continue
                blocks = -(-N // bn) * c
                if blocks >= FUSED_MIN_BLOCKS:
                    return bn, c, r, need(bn, r, True), True
                if best is None or blocks > best[0]:
                    best = (blocks, bn, c, r)
        if best is not None:
            _, bn, c, r = best
            return bn, c, r, need(bn, r, True), True
    bn, c = FUSED_BNS[-1], FUSED_CLUSTERS[-1]
    return bn, c, -(-K // c), need(bn, 0, False), False


def _fused_launcher():
    if not _LAUNCH:
        fn = _build.load('fake_quant').fake_quant_fused_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def fake_quant_plain(w, *, bits=8):
    """The fused kernel's function in plain PyTorch: fp32 math, the output
    in w's dtype."""
    fake_quant_plain.calls += 1
    return fake_quant_ref(w.float(), bits).to(w.dtype)


fake_quant_plain.calls = 0


def fake_quant_two_pass_plain(w, *, bits=8):
    """The two-pass pair's function in plain PyTorch (the same function as
    :func:`fake_quant_plain`, counted apart)."""
    fake_quant_two_pass_plain.calls += 1
    return fake_quant_ref(w.float(), bits).to(w.dtype)


fake_quant_two_pass_plain.calls = 0


def _check(w, name):
    if w.dim() != 2 or w.dtype not in (torch.float32, torch.bfloat16) \
            or not w.is_contiguous() or w.numel() >= 2 ** 31:
        raise ValueError(f'{name}: expected a contiguous fp32 or bf16 (K, N) '
                         f'with fewer than 2**31 elements, got {w.dtype} '
                         f'{tuple(w.shape)}')


def fake_quant_fused(w, *, bits=8):
    """Per-output-channel (last dim) symmetric fake quant of an fp32 or bf16
    w (K, N) in one launch: the CUDA cluster kernel for a CUDA tensor, the
    plain version for a CPU one."""
    if not w.is_cuda:
        return fake_quant_plain(w, bits=bits)
    _check(w, 'fake_quant_fused')
    K, N = w.shape
    out = torch.empty_like(w)
    if K == 0 or N == 0:
        return out
    qmax = 2.0 ** (bits - 1) - 1.0
    eb = w.element_size()
    bn, c, r, smem, staged = fused_plan(K, N, eb)
    vec = (N * eb) % 16 == 0 and w.data_ptr() % 16 == 0 and \
        out.data_ptr() % 16 == 0
    rc = _fused_launcher()(
        w.data_ptr(), out.data_ptr(), K, N, bn, c, r, smem, int(staged),
        int(vec), int(w.dtype == torch.bfloat16), qmax, recip32(qmax),
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc:
        _build.check(_build.load('fake_quant'), rc, 'fake_quant_fused launch')
    fake_quant_fused.launches += 1
    return out


fake_quant_fused.launches = 0


def fake_quant(w, *, bits=8):
    """The same fake quant as :func:`fake_quant_fused` in two kernels, the
    tile-parallel abs-max and then the quantize pass: the Triton pair for a
    CUDA tensor, the plain version for a CPU one."""
    if not w.is_cuda:
        return fake_quant_two_pass_plain(w, bits=bits)
    _check(w, 'fake_quant')
    K, N = w.shape
    out = torch.empty_like(w)
    if K == 0 or N == 0:
        return out
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = torch.zeros((N,), dtype=torch.float32, device=w.device)
    kernels = _jit()
    grid = (-(-K // TILE_K), -(-N // TILE_N))
    with torch.cuda.device(w.device):
        kernels['_amax_kernel'][grid](w, amax, K, N, BK=TILE_K,
                                      BN=TILE_N, num_warps=4)
        kernels['_quant_kernel'][grid](w, amax, out, K, N, qmax,
                                       recip32(qmax), BK=TILE_K, BN=TILE_N,
                                       num_warps=4)
    fake_quant.launches += 1
    return out


fake_quant.launches = 0
