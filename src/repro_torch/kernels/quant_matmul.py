"""W8A8 quantized matmul: the hand-written CUDA kernel
(``csrc/quant_matmul.cu``), its wrapper and its plain version.

Replaces the reference's Pallas ``quant_matmul`` / ``_qmm_kernel``
(src/repro/kernels/quant_matmul.py): int8 x (M,K) @ int8 w (K,N) into an
int32 accumulator, then ``acc * (sx[m] * sw[n])``, optional bias and ReLU,
and with ``out_scale`` the requantize epilogue that writes int8 on a
static grid.  The reference zero-pads awkward dims to 128; the CUDA kernel
masks its ragged edges instead, so nothing is padded in device memory.

:func:`quant_matmul` launches the kernel for a CUDA tensor and runs
:func:`quant_matmul_plain` for a CPU tensor; nothing else decides.
``quant_matmul.launches`` counts kernel launches and
``quant_matmul_plain.calls`` counts plain-version calls, so a run can
show which of the two served it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import epilogue, int_matmul, recip32

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
    [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_LAUNCH = []         # the bound C entry point, set up on first launch


def _launcher():
    if not _LAUNCH:
        fn = _build.load('quant_matmul').quant_matmul_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def quant_matmul_plain(x_q, w_q, sx, sw, bias=None, *, relu=False,
                       out_scale=None, out_qmax=127.0):
    """The kernel's function in plain PyTorch, in the kernel's op order."""
    quant_matmul_plain.calls += 1
    return epilogue(int_matmul(x_q, w_q), sx[:, None] * sw[None, :], bias,
                    relu, out_scale, out_qmax)


quant_matmul_plain.calls = 0


def _check_operands(x_q, w_q, sx, sw, bias):
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f'quant_matmul: x {tuple(x_q.shape)} and w '
                         f'{tuple(w_q.shape)} are not (M,K) and (K,N)')
    M, N = x_q.shape[0], w_q.shape[1]
    want = [(x_q, torch.int8, None), (w_q, torch.int8, None),
            (sx, torch.float32, (M,)), (sw, torch.float32, (N,))]
    if bias is not None:
        want.append((bias, torch.float32, (N,)))
    _build.check_operands('quant_matmul', x_q.device, want)


def quant_matmul(x_q, w_q, sx, sw, bias=None, *, relu=False, out_scale=None,
                 out_qmax=127.0):
    """x_q int8 (M,K); w_q int8 (K,N); sx fp32 (M,); sw fp32 (N,); bias
    fp32 (N,) or None.  Returns fp32 (M,N), or int8 when ``out_scale`` (a
    static Python float) is set."""
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
    vec_x = K % 16 == 0 and x_q.data_ptr() % 16 == 0
    vec_w = N % 4 == 0 and w_q.data_ptr() % 4 == 0
    rc = _launcher()(
        x_q.data_ptr(), w_q.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        M, N, K, int(relu), int(out_int8),
        recip32(out_scale) if out_int8 else 1.0, float(out_qmax),
        int(vec_x), int(vec_w),
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if rc:
        _build.check(_build.load('quant_matmul'), rc, 'quant_matmul launch')
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
