"""Per-channel fake quantization: a CUDA kernel over thread-block clusters
behind two wrappers, and their plain versions.

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
  the same way).  That budget is the TPU's: a cluster's shared memory
  holds the stripe, so the wrapper launches the same cluster kernel on
  the same plan, one launch and one read of w where the reference reads
  it twice (tinyllama's MLP ``wo`` (5632, 2048) in bf16: 64-column
  stripes on clusters of 16, 352-row slices).  It keeps its own launch
  count and plain version, so a run shows which wrapper served a weight.

Both are an elementwise pass and a column reduction with no product for
the tensor cores: they are bound by bytes (read w, write the output).
Ragged edges are masked; nothing is padded in device memory.

Numerics match the plain versions bit for bit: the scale multiplies by the
fp32 reciprocal of qmax (as the reference's compiled kernels do), the
division ``w / scale`` is IEEE-rounded (``__fdiv_rn``), rounding is half
to even (``rint``), and the store's fp32 -> bf16 cast rounds to nearest
even.  The CUDA library is built on its first launch (kernels/_build.py).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, recorded
from repro_torch.kernels.ref import fake_quant_ref, recip32
from repro_torch.kernels.tiling import SMEM_BUDGET

# The cluster kernel's launch plan (csrc/fake_quant.cu).  A stripe is BN
# columns wide and a cluster of C blocks splits it along K; BN is a power
# of two from 16 to 128 (the kernel's 256 threads split a stripe row
# evenly).  C stays within the portable cluster size of 8 unless K is tall:
# where 8 blocks cannot stage 128-byte stripe rows in the static shared
# memory, 16 (a non-portable size the kernel opts into) keeps the slices
# small at that width (scripts/fq_plan_sweep.py).
FUSED_BNS = (128, 64, 32, 16)
FUSED_CLUSTERS = (1, 2, 4, 8)
TALL_CLUSTER = 16
FUSED_MIN_BLOCKS = 132       # one block for each SM of an H100
STATIC_SMEM = 48 * 1024      # above this a block needs the opt-in attribute

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]
_LAUNCH = []         # the bound C entry point, set up on first launch


def fused_plan(K: int, N: int, elem_bytes: int):
    """Launch plan of the cluster kernel for a (K, N) weight of
    ``elem_bytes`` bytes an element: ``(BN, C, R, smem_bytes, staged)``.

    Block r of a cluster owns rows [r*R, min((r+1)*R, K)) of a BN-column
    stripe; the grid is (ceil(N / BN), C).  Among the slices that fit
    without the opt-in shared memory, then among those that fit
    ``SMEM_BUDGET``, on clusters of up to 8 (16 where K is tall), the
    widest stripe on the smallest cluster that runs ``FUSED_MIN_BLOCKS``
    blocks wins, else the plan with the most blocks (small slices also let
    several blocks share an SM, so one block's loads overlap another's
    stores).  Where no slice fits (a very tall, narrow weight), ``staged``
    is False: 16-column stripes on clusters of 8, each block walking its
    rows twice from device memory."""
    def need(bn, r, staged):
        return 8 * bn + (r * bn * elem_bytes if staged else 0)

    tall = need(128 // elem_bytes, -(-K // FUSED_CLUSTERS[-1]), True) > \
        STATIC_SMEM
    clusters = FUSED_CLUSTERS + ((TALL_CLUSTER,) if tall else ())
    for limit in (STATIC_SMEM, SMEM_BUDGET):
        best = None
        for bn in FUSED_BNS:
            for c in clusters:
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


def _launch(w, bits):
    """The cluster kernel on w (on the card) on :func:`fused_plan`."""
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
        _build.check(_build.load('fake_quant'), rc, 'fake_quant launch')
    return out


def fq_call_plan(w, **_):
    """``(route, plan, shared-memory bytes)`` of a call: the cluster
    kernel on :func:`fused_plan` (a 2-D w; the card takes no other)."""
    if w.dim() != 2:
        return 'cluster', None, None
    plan = fused_plan(*w.shape, w.element_size())
    return 'cluster', plan, plan[3]


@recorded('fake_quant_fused', fq_call_plan)
def fake_quant_fused(w, *, bits=8):
    """Per-output-channel (last dim) symmetric fake quant of an fp32 or bf16
    w (K, N) in one launch: the CUDA cluster kernel for a CUDA tensor, the
    plain version for a CPU one."""
    if not w.is_cuda:
        return fake_quant_plain(w, bits=bits)
    _check(w, 'fake_quant_fused')
    out = _launch(w, bits)
    fake_quant_fused.launches += 1
    return out


fake_quant_fused.launches = 0


@recorded('fake_quant', fq_call_plan)
def fake_quant(w, *, bits=8):
    """The same fake quant as :func:`fake_quant_fused`, for the weights the
    reference sends to its two passes: the CUDA cluster kernel in one read
    of w for a CUDA tensor, the plain version for a CPU one."""
    if not w.is_cuda:
        return fake_quant_two_pass_plain(w, bits=bits)
    _check(w, 'fake_quant')
    out = _launch(w, bits)
    fake_quant.launches += 1
    return out


fake_quant.launches = 0
