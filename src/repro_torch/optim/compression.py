"""Gradient compression for the data-parallel all-reduce: the reference's
``optim/compression.py`` over the port's trees.

int8 quantization with one scale a tensor and an error-feedback residual
(1-bit-Adam style): each round compresses ``g + residual`` and carries
what the int8 codes lost into the next round, so the compression stays
unbiased over rounds.  The arithmetic is the reference's eager one:
``s = max(max|g|, 1e-12) / 127`` and ``g / s`` are IEEE divisions, the
rounding is half to even, and ``g - q * s`` is a product then a
difference (not fused), so codes, scales and residuals are the
reference's bit for bit.

The reference's ``allreduce_compressed`` (a ``psum``/``pmax`` of the codes
inside ``shard_map``) belongs to the mesh code, which the port has not
ported (ROADMAP, queue A item 10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import true_div
from repro_torch.tree import tree_map


def _compress(g, r):
    g = g.to(torch.float32) + r
    s = true_div(torch.clamp_min(torch.max(torch.abs(g)), 1e-12), 127.0)
    q = torch.clamp(torch.round(g / s), -128, 127).to(torch.int8)
    return q, s, g - q.to(torch.float32) * s


@torch.no_grad()
def int8_compress_grads(grads, residual):
    """Returns (q int8, scales fp32 0-d, new residual fp32), each a tree of
    ``grads``' structure; ``residual=None`` starts from zeros."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)
    parts = []
    tree_map(lambda g, r: parts.append(_compress(g, r)), grads, residual)
    return tuple(_like(grads, [p[i] for p in parts]) for i in range(3))


def _like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in the order
    ``tree_map`` visits it."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def int8_decompress(q, s):
    return tree_map(lambda qi, si: qi.to(torch.float32) * si, q, s)
