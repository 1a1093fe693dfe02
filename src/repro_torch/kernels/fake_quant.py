"""Per-channel fake quantization: three Triton kernels behind two wrappers,
and their plain versions.

For a 2-D weight w (K, N), each column gets ``scale = max(amax, 1e-8) /
qmax`` from its abs-max, and the output is ``clip(round(w / scale),
-qmax-1, qmax) * scale``.  The weight is read as fp32 (fp32 or bf16 in
device memory), the arithmetic is fp32, and the output is written in w's
dtype, rounded to nearest even: the reference's kernels upcast, quantize
and cast back the same way.

* :func:`fake_quant_fused` replaces the reference's ``fake_quant_fused`` /
  ``_fused_kernel`` (src/repro/kernels/fake_quant.py).  One program owns a
  BN-column stripe and loops over K twice: first the abs-max, then the
  quantize pass.  The Pallas kernel holds the whole (K, bn) stripe in
  VMEM; a Triton program streams it through registers, so any K fits and
  W is read twice from device memory (the second read mostly from L2).
* :func:`fake_quant` replaces the reference's two-pass ``fake_quant`` /
  ``_amax_kernel`` + ``_quant_kernel``, which the reference takes when a
  (K, 256) fp32 stripe overflows its VMEM budget (kernels/ops.py routes
  the same way).  On this card the point of two passes is parallelism,
  not memory: at tinyllama's MLP ``wo`` (5632, 2048) the fused grid has 32
  programs for 132 SMs, each walking K twice.  Here ``_amax_kernel`` runs
  one program per (BK, BN) tile and merges its column maxima into a zeroed
  fp32 (N,) buffer with ``atomic_max`` (|w| >= 0, and a max does not
  depend on the order of its terms, so the result is deterministic);
  ``_quant_kernel`` then quantizes one (BK, BN) tile per program.  The
  wrapper counts one launch for the pair.

All three are elementwise passes and a column reduction with no product
for the tensor cores: they are bound by bytes (read w, write the output),
which Triton's masked 2-D block loads express as well as CUDA would.
Ragged edges are masked; nothing is padded in device memory, and masked
loads read 0, which never wins an abs-max.

Numerics match the plain versions bit for bit: the scale multiplies by the
fp32 reciprocal of qmax (as the reference's compiled kernels do), the
division ``w / scale`` is IEEE-rounded (``div_rn``: Triton may lower an
fp32 ``/`` to an approximate division), rounding is half to even
(libdevice ``rint``), and the store's fp32 -> bf16 cast rounds to nearest
even.

``triton`` is imported on the first launch, never when this module is
imported: hosts without a card have no triton.  The kernel bodies read
``tl``, ``libdevice`` and ``_quantize`` as module globals bound at that
point; their annotations stay strings (``from __future__ import
annotations``), which Triton reads as constexpr markers.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels._build import BUILD_ROOT
from repro_torch.kernels.ref import fake_quant_ref, recip32

tl = None            # triton.language, bound by _jit()
libdevice = None     # triton.language.extra.libdevice, bound by _jit()
_quantize = None     # triton.jit(_quantize_body), bound by _jit()
_KERNELS = {}

TILE_K, TILE_N = 64, 128     # the two-pass kernels' tile (128 columns a row)


def _quantize_body(w, scale, qmax):
    """``clip(rint(w / scale), -qmax-1, qmax) * scale`` on an fp32 tile,
    one scale per column."""
    q = libdevice.rint(tl.math.div_rn(w, scale[None, :]))
    q = tl.minimum(tl.maximum(q, -qmax - 1.0), qmax)
    return q * scale[None, :]


def _fused_kernel(w_ptr, o_ptr, K, N, qmax, inv_qmax, BK: tl.constexpr,
                  BN: tl.constexpr):
    cols = tl.program_id(0) * BN + tl.arange(0, BN)
    cmask = cols < N
    amax = tl.zeros((BN,), dtype=tl.float32)
    for k0 in range(0, K, BK):
        rows = k0 + tl.arange(0, BK)
        mask = (rows[:, None] < K) & cmask[None, :]
        w = tl.load(w_ptr + rows[:, None] * N + cols[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        amax = tl.maximum(amax, tl.max(tl.abs(w), axis=0))
    scale = tl.maximum(amax, 1e-8) * inv_qmax
    for k0 in range(0, K, BK):
        rows = k0 + tl.arange(0, BK)
        mask = (rows[:, None] < K) & cmask[None, :]
        offs = rows[:, None] * N + cols[None, :]
        w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        tl.store(o_ptr + offs,
                 _quantize(w, scale, qmax).to(o_ptr.dtype.element_ty),
                 mask=mask)


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
        os.environ.setdefault('TRITON_CACHE_DIR', str(BUILD_ROOT / 'triton'))
        import triton
        import triton.language
        from triton.language.extra import libdevice as _libdevice
        tl, libdevice = triton.language, _libdevice
        _quantize = triton.jit(_quantize_body)
        for fn in (_fused_kernel, _amax_kernel, _quant_kernel):
            _KERNELS[fn.__name__] = triton.jit(fn)
    return _KERNELS


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
    w (K, N) in one kernel: the Triton kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if not w.is_cuda:
        return fake_quant_plain(w, bits=bits)
    _check(w, 'fake_quant_fused')
    K, N = w.shape
    out = torch.empty_like(w)
    if K == 0 or N == 0:
        return out
    qmax = 2.0 ** (bits - 1) - 1.0
    bn = 16 if N <= 16 else 64
    kernel = _jit()['_fused_kernel']
    with torch.cuda.device(w.device):
        kernel[(-(-N // bn),)](w, out, K, N, qmax, recip32(qmax), BK=128,
                               BN=bn, num_warps=4)
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
