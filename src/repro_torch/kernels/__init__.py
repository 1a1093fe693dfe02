"""Hand-written Hopper kernels of the port, with their plain versions.

=====================  ====================================================
Kernel                 Replaces (src/repro/kernels/)
=====================  ====================================================
``quant_matmul``       ``quant_matmul.py`` ``_qmm_kernel``: W8A8 GEMM with
(CUDA C++,             int32 accumulation and the fused dequant + bias +
``csrc/``)             ReLU (+ requantize) epilogue; serves every conv
                       through the im2col lowering in ``quant_conv.py``
                       and every dense head; TMA + ``wgmma`` with K split
                       over a cluster where K % 16 == 0, ``mma.sync``
                       for the rest
``fake_quant_fused``   ``fake_quant.py`` ``_fused_kernel``: per-column
(CUDA C++,             symmetric fake quant of a 2-D fp32 or bf16 weight
``csrc/``)             in one launch, a cluster of blocks splitting each
                       column stripe along K and merging the column
                       maxima over distributed shared memory; QAT and
                       export
``fake_quant``         ``fake_quant.py`` ``_amax_kernel`` +
(CUDA C++,             ``_quant_kernel``: the same function, for the
``csrc/``)             weights the reference sends to its two passes
                       (K * min(N, 256) * 4 B over 4 MiB: tinyllama's MLP
                       ``wo`` in QAT), served by the cluster kernel of
                       ``fake_quant_fused`` in one read of w
``depthwise_conv``     ``depthwise_conv.py`` ``_dw_kernel``: direct int8
(CUDA C++,             SAME depthwise conv (per-group input depth 1, any
``csrc/``)             channel multiplier) with the shared epilogue;
                       serves MobileNet's ``dw`` layers
``lowrank_conv``       ``lowrank_conv.py`` ``_lr_kernel``: a factored
(CUDA C++,             (u, v) conv pair in one launch, the rank
``csrc/``)             intermediate requantized to int8 in shared memory;
                       serves the factored layers inside the fused
                       envelope; TMA + ``wgmma`` with K1 split over a
                       cluster where K1 % 16 == 0, ``mma.sync`` for the
                       rest
``decode_attention``   ``decode_attention.py`` ``_decode_kernel``: one-token
(CUDA C++,             GQA flash-decode over a bf16/fp32 (B,S,K,D) cache
``csrc/``)             with a ``valid`` mask, S split over a cluster of
                       blocks merged over distributed shared memory;
                       serves every layer of every LM decode step
``decode_attention_    ``decode_attention.py`` ``_decode_kernel_int8``: the
int8`` (CUDA C++,      same over an int8 cache with fp32 scales per
``csrc/``)             (token, kv head) (``kv_cache_bits=8``), on the
                       same split kernel, one scale multiply a slot
=====================  ====================================================

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor.  :func:`counts` reads the launch and plain-call
counters and :func:`reset_counts` zeroes them (and the launches by route
of ``quant_matmul``, ``lowrank_conv`` and ``depthwise_conv``, and the
weight relayouts of the first two), so a run can show which path served
it.

Inside a :func:`recording` block every wrapper call, on either branch,
appends a :class:`KernelCall`: the kernel, the route its operands select,
whether the plain version ran, the operands' and outputs' shapes and
dtypes, and the launch plan the wrapper computes with its shared memory.
The plans are plain Python, so a CPU run records the calls and plans the
card runs.  Outside such a block a wrapper pays one list test.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Callable, NamedTuple

import torch


class KernelCall(NamedTuple):
    """One wrapper call, as :func:`recording` keeps it."""
    kernel: str
    route: str              # the route the operands select on the card
    plain: bool             # the plain version ran (a CPU tensor)
    operands: tuple         # ((argument, shape, dtype), ...) of the tensors
    outputs: tuple          # ((shape, dtype), ...)
    plan: Any               # the launch plan, None where the kernel has none
    smem_bytes: int | None  # the plan's shared memory; None: static only
    args: dict | None       # the arguments as bound (``keep_args``)

    @property
    def out_bytes(self) -> int:
        """Bytes the call writes: each output once."""
        return sum(_numel(s) * d.itemsize for s, d in self.outputs)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


_OPEN: list = []        # (calls, keep_args) of each open recording() block
_DEPTH = [0]            # wrapper calls in progress while one is open


@contextlib.contextmanager
def recording(*, keep_args: bool = False):
    """Record every kernel wrapper call made inside the block into the
    list it yields (:class:`KernelCall`, in call order).  ``keep_args``
    keeps each call's bound arguments (the tensors too) in ``args``."""
    entry = ([], keep_args)
    _OPEN.append(entry)
    try:
        yield entry[0]
    finally:
        _OPEN.remove(entry)


def inside_wrapper() -> bool:
    """True while a recorded wrapper call runs (its plain version's torch
    ops or its launch), so an op recorder can leave them out."""
    return _DEPTH[0] > 0


def tensors_in(value) -> list:
    """Every tensor in a value: a tensor, or tensors nested in tuples,
    lists and dicts."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in tensors_in(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in tensors_in(v)]
    return []


def recorded(kernel: str, plan: Callable):
    """Decorate a kernel wrapper so that calls inside :func:`recording`
    are recorded.  ``plan(**bound arguments)`` returns ``(route, launch
    plan or None, shared-memory bytes or None)`` as the wrapper computes
    them."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _OPEN:
                return fn(*a, **kw)
            b = sig.bind(*a, **kw)
            b.apply_defaults()
            args = dict(b.arguments)
            _DEPTH[0] += 1
            try:
                out = fn(*a, **kw)
            finally:
                _DEPTH[0] -= 1
            route, p, smem = plan(**args)
            first = next(t for v in args.values() for t in tensors_in(v))
            call = KernelCall(
                kernel, route, not first.is_cuda,
                tuple((k, tuple(t.shape), t.dtype) for k, v in args.items()
                      for t in tensors_in(v)),
                tuple((tuple(t.shape), t.dtype) for t in tensors_in(out)),
                p, smem, None)
            for calls, keep in _OPEN:
                calls.append(call._replace(args=args) if keep else call)
            return out
        return wrapper
    return deco


def _wrappers() -> dict:
    """``{kernel: (wrapper, plain version)}`` for every ported kernel."""
    from repro_torch.kernels import (decode_attention, depthwise_conv,
                                     fake_quant, lowrank_conv, quant_matmul)
    return {'quant_matmul': (quant_matmul.quant_matmul,
                             quant_matmul.quant_matmul_plain),
            'fake_quant_fused': (fake_quant.fake_quant_fused,
                                 fake_quant.fake_quant_plain),
            'fake_quant': (fake_quant.fake_quant,
                           fake_quant.fake_quant_two_pass_plain),
            'depthwise_conv': (depthwise_conv.depthwise_conv,
                               depthwise_conv.depthwise_conv_plain),
            'lowrank_conv': (lowrank_conv.lowrank_conv,
                             lowrank_conv.lowrank_conv_plain),
            'decode_attention': (decode_attention.decode_attention,
                                 decode_attention.decode_attention_plain),
            'decode_attention_int8': (
                decode_attention.decode_attention_int8,
                decode_attention.decode_attention_int8_plain)}


def counts() -> dict:
    """``{kernel: {'launches': n, 'plain_calls': m}}`` since the last
    reset."""
    return {k: {'launches': w.launches, 'plain_calls': p.calls}
            for k, (w, p) in _wrappers().items()}


def reset_counts() -> None:
    from repro_torch.kernels import depthwise_conv, lowrank_conv, quant_matmul
    for w, p in _wrappers().values():
        w.launches = 0
        p.calls = 0
    quant_matmul.reset_route_counts()
    lowrank_conv.reset_route_counts()
    depthwise_conv.reset_route_counts()
