"""Gradient compression for the data-parallel all-reduce: the reference's
``optim/compression.py`` over the port's trees.

int8 quantization with one scale a tensor and an error-feedback residual
(1-bit-Adam style): each round compresses ``g + residual`` and carries
what the int8 codes lost into the next round, so the compression stays
unbiased over rounds.  The arithmetic is the reference's eager one:
``s = max(max|g|, 1e-12) / 127`` and ``g / s`` are IEEE divisions, the
rounding is half to even, and ``g - q * s`` is a product then a
difference (not fused), so codes, scales and residuals are the
reference's bit for bit (``jitted=True``: those of the reference's call
under jit, where XLA folds and fuses, as ``allreduce_compressed`` runs).

:func:`allreduce_compressed` is the data-parallel all-reduce on that
payload over ``torch.distributed``: the reference's ``psum`` of the codes
(as int32) and ``pmax`` of the scales inside ``shard_map`` become
``all_reduce`` SUM and MAX over the process group(s) of the DP axes (one
group, or one per axis as the reference names its axes).  Integer sums
and maxima do not depend on the order of the ranks, so every rank gets
the reference's mean bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import recip32, true_div
from repro_torch.tree import tree_map


def _compress(g, r, jitted=False):
    """(codes, scale, residual) of ``g + r``: the reference's eager
    arithmetic, or (``jitted``) what XLA makes of it under jit: the
    constant divisor folded into ``max|g| * fp32(1/127)`` and the residual
    ``g - q * s`` fused into one rounding (computed exactly in fp64: an
    int8 code times an fp32 scale and its difference from g fit in 53
    bits)."""
    g = g.to(torch.float32) + r
    amax = torch.clamp_min(torch.max(torch.abs(g)), 1e-12)
    s = amax * recip32(127.0) if jitted else true_div(amax, 127.0)
    q = torch.clamp(torch.round(g / s), -128, 127).to(torch.int8)
    if jitted:
        res = (g.to(torch.float64) - q.to(torch.float64)
               * s.to(torch.float64)).to(torch.float32)
    else:
        res = g - q.to(torch.float32) * s
    return q, s, res


@torch.no_grad()
def int8_compress_grads(grads, residual, *, jitted=False):
    """Returns (q int8, scales fp32 0-d, new residual fp32), each a tree of
    ``grads``' structure; ``residual=None`` starts from zeros.
    ``jitted``: the arithmetic of the reference's call under jit."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)
    parts = []
    tree_map(lambda g, r: parts.append(_compress(g, r, jitted)), grads,
             residual)
    return tuple(_like(grads, [p[i] for p in parts]) for i in range(3))


def _like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in the order
    ``tree_map`` visits it."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def int8_decompress(q, s):
    return tree_map(lambda qi, si: qi.to(torch.float32) * si, q, s)


def allreduce_compressed(grads, residual, group):
    """The mean of every rank's int8-compressed ``grads`` over ``group``
    (a ProcessGroup, or a sequence of them: the DP axes), and this rank's
    new residual.  Codes are summed as int32, scales reduced by their max
    (every replica dequantizes with the largest scale, so the wire stays
    int8), and the mean is ``summed * s_max / n`` in the reference's
    order.  The reference runs it inside a jitted shard_map, so the
    compression takes the jitted arithmetic (``int8_compress_grads(...,
    jitted=True)``)."""
    import torch.distributed as dist
    groups = tuple(group) if isinstance(group, (list, tuple)) else (group,)
    q, s, r = int8_compress_grads(grads, residual, jitted=True)
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)

    def reduce(x, op):
        for g in groups:
            dist.all_reduce(x, op=op, group=g)
        return x
    summed = tree_map(lambda qi: reduce(qi.to(torch.int32), dist.ReduceOp.SUM),
                      q)
    s_max = tree_map(lambda si: reduce(si.clone(), dist.ReduceOp.MAX), s)
    mean = tree_map(lambda qi, si: true_div(qi.to(torch.float32) * si,
                                            float(n)), summed, s_max)
    return mean, r
