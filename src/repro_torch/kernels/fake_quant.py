"""Fused per-channel fake quantization: a Triton kernel, its wrapper and its
plain version.

Replaces the reference's Pallas ``fake_quant_fused`` / ``_fused_kernel``
(src/repro/kernels/fake_quant.py): for a 2-D weight w (K, N), each column
gets ``scale = max(amax, 1e-8) / qmax`` from its abs-max, and the output
is ``clip(round(w / scale), -qmax-1, qmax) * scale``.

The work is a per-column reduction followed by one elementwise pass, which
Triton expresses as well as CUDA would.  One program owns a BN-column
stripe and loops over K twice: first the abs-max, then the quantize pass.
The Pallas kernel holds the whole (K, bn) stripe in VMEM; a Triton program
streams it through registers instead, so any K fits and W is read twice
from device memory (the second read mostly from L2).  The kernel is bound
by bytes: read w, write the output.

Numerics match the plain version bit for bit: the scale multiplies by the
fp32 reciprocal of qmax (as the reference's compiled kernel does), the
division ``w / scale`` is IEEE-rounded (``div_rn``: Triton may lower an
fp32 ``/`` to an approximate division), and rounding is half to even
(libdevice ``rint``).

``triton`` is imported on the first launch, never when this module is
imported: hosts without a card have no triton.  The kernel body reads
``tl`` and ``libdevice`` as module globals bound at that point; its
annotations stay strings (``from __future__ import annotations``), which
Triton reads as constexpr markers.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels._build import BUILD_ROOT
from repro_torch.kernels.ref import fake_quant_ref, recip32

tl = None            # triton.language, bound by _jit()
libdevice = None     # triton.language.extra.libdevice, bound by _jit()
_JIT = []


def _fused_kernel(w_ptr, o_ptr, K, N, qmax, inv_qmax, BK: tl.constexpr,
                  BN: tl.constexpr):
    cols = tl.program_id(0) * BN + tl.arange(0, BN)
    cmask = cols < N
    amax = tl.zeros((BN,), dtype=tl.float32)
    for k0 in range(0, K, BK):
        rows = k0 + tl.arange(0, BK)
        mask = (rows[:, None] < K) & cmask[None, :]
        w = tl.load(w_ptr + rows[:, None] * N + cols[None, :], mask=mask,
                    other=0.0)
        amax = tl.maximum(amax, tl.max(tl.abs(w), axis=0))
    scale = tl.maximum(amax, 1e-8) * inv_qmax
    for k0 in range(0, K, BK):
        rows = k0 + tl.arange(0, BK)
        mask = (rows[:, None] < K) & cmask[None, :]
        offs = rows[:, None] * N + cols[None, :]
        w = tl.load(w_ptr + offs, mask=mask, other=0.0)
        q = libdevice.rint(tl.math.div_rn(w, scale[None, :]))
        q = tl.minimum(tl.maximum(q, -qmax - 1.0), qmax)
        tl.store(o_ptr + offs, q * scale[None, :], mask=mask)


def _jit():
    """Import triton and wrap the kernel body, once per process."""
    global tl, libdevice
    if not _JIT:
        os.environ.setdefault('TRITON_CACHE_DIR', str(BUILD_ROOT / 'triton'))
        import triton
        import triton.language
        from triton.language.extra import libdevice as _libdevice
        tl, libdevice = triton.language, _libdevice
        _JIT.append(triton.jit(_fused_kernel))
    return _JIT[0]


def fake_quant_plain(w, *, bits=8):
    """The kernel's function in plain PyTorch."""
    fake_quant_plain.calls += 1
    return fake_quant_ref(w, bits)


fake_quant_plain.calls = 0


def fake_quant_fused(w, *, bits=8):
    """Per-output-channel (last dim) symmetric fake quant of fp32 w (K, N):
    the Triton kernel for a CUDA tensor, the plain version for a CPU one."""
    if not w.is_cuda:
        return fake_quant_plain(w, bits=bits)
    if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f'fake_quant_fused: expected contiguous fp32 (K, N), '
                         f'got {w.dtype} {tuple(w.shape)}')
    K, N = w.shape
    out = torch.empty_like(w)
    if K == 0 or N == 0:
        return out
    qmax = 2.0 ** (bits - 1) - 1.0
    bn = 16 if N <= 16 else 64
    kernel = _jit()
    with torch.cuda.device(w.device):
        kernel[(-(-N // bn),)](w, out, K, N, qmax, recip32(qmax), BK=128,
                               BN=bn, num_warps=4)
    fake_quant_fused.launches += 1
    return out


fake_quant_fused.launches = 0
