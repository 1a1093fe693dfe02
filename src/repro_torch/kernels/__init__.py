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
"""
from __future__ import annotations


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
