"""Sequence-sharded decode attention: the functions injected into the
model's ``ctx`` (the reference's ``launch/serving.py``).

The decode caches are sequence-sharded (see ``launch/sharding.py``): each
rank computes flash-decode partials over its local cache chunk and the
partials merge with an all-reduce max and sums (softmax merge) across the
sequence axes.  This is what lets GQA archs whose kv_heads (1-8) don't
divide the 16-way model axis still shard their caches, and what makes the
500k-context cells fit.

The math is ``models/attention``'s ``decode_attn_reference`` and
``decode_mla_reference`` with ``groups`` set: the same code as the
single-device functions, so the CPU tests and the sharded path cannot
drift apart.  Where the reference wraps them in ``shard_map``, the port's
sharded steps (``launch/steps.py``) already run one program per rank on
local tensors: the ctx's functions take this rank's chunk of the batch and
of the cache (global slot indices in ``meta['slots']``) and merge over
the process groups of the sequence axes.  A cache whose sequence dim did
not divide (the rules then leave it whole on every rank) is attended with
no merge.  :func:`decode_spec` is the layout the reference's shard_map
gives a cache (its ``cache_specs``, every leaf of the tree): k, v, their
int8 scales, MLA's latent and rope key, and the slots and positions are
sequence-sharded; a recurrent state is whole but for its batch.
"""
from __future__ import annotations

import math

from repro_torch.launch.mesh import data_axes, mesh_axes
from repro_torch.launch.sharding import MODEL, P, _div, _path_keys
from repro_torch.models.attention import (decode_attn_reference,
                                          decode_mla_reference)

SEQ_LEAVES = ('k', 'v', 'k_s', 'v_s', 'ckv', 'kr')


def seq_axes(mesh, long_ctx=False) -> tuple:
    dp = data_axes(mesh)
    return (dp + (MODEL,)) if long_ctx else (MODEL,)


def cache_dims(path):
    """(batch dim, sequence dim) of a cache leaf at ``path``, None where it
    has none."""
    keys = _path_keys(path)
    off = 1 if 'blocks' in keys else 0
    name = keys[-1]
    if name in SEQ_LEAVES:
        return off, off + 1
    if name in ('slots', 'pos'):
        return None, off
    if name == 'total':
        return None, None
    return off, None


def decode_spec(path, leaf, mesh, *, long_ctx=False):
    """The spec of a cache leaf inside the decode: its batch dim over the
    DP axes (none with ``long_ctx``), its sequence dim over
    :func:`seq_axes`; an axis that does not divide its dim is dropped, as
    the rules do."""
    dp = data_axes(mesh)
    sa = seq_axes(mesh, long_ctx)
    b_dim, s_dim = cache_dims(path)
    spec = [None] * len(leaf.shape)
    if b_dim is not None and not long_ctx:
        spec[b_dim] = dp if len(dp) > 1 else dp[0]
    if s_dim is not None:
        spec[s_dim] = sa if len(sa) > 1 else sa[0]
    return P(*(s if s is None or _div(leaf.shape[d], mesh, s) else None
               for d, s in enumerate(spec)))


def make_decode_ctx(mesh, cfg, *, max_len, long_ctx=False):
    """ctx dict with the sequence-sharded decode_attn / decode_mla.

    ``max_len``: the caches' ``max_len``.  A ring holds ``max_len``
    slots, or ``min(window, max_len)`` for a local layer's as
    ``init_cache`` builds it, so the host reads nothing off the device to
    tell a whole ring from a chunk of one.  A rank's chunk of a ring
    starts at its index over the sequence axes (row-major in mesh order,
    as DTensor splits a dim) times the chunk's length."""
    sizes = mesh_axes(mesh)
    axes = seq_axes(mesh, long_ctx)
    n_seq = math.prod(sizes[a] for a in axes)
    groups = tuple(mesh.get_group(a) for a in axes if sizes[a] > 1)
    index = 0
    for a in axes:
        index = index * sizes[a] + (mesh.get_local_rank(a) if sizes[a] > 1
                                    else 0)

    def merge_over(cache, key, window=0):
        """The groups to merge over and this rank's chunk of the ring:
        none where this rank holds the whole sequence (on a mesh of one
        rank, without reading the ring's size off the device)."""
        if not groups:
            return (), None
        n_local = cache[key].shape[1]
        rings = (max_len, min(window, max_len)) if window else (max_len,)
        if n_local in rings:
            return (), None
        total = n_local * n_seq
        if total not in rings:
            raise ValueError(f'a cache chunk of {n_local} slots is not 1/'
                             f'{n_seq} of a ring of {rings}')
        return groups, (index * n_local, total)

    def decode_attn(q, nk, nv, cache, cur, *, window=0, attn_softcap=0.0):
        g, chunk = merge_over(cache, 'k', window)
        return decode_attn_reference(q, nk, nv, cache, cur, window=window,
                                     attn_softcap=attn_softcap, groups=g,
                                     chunk=chunk)

    def decode_mla(q_lat, q_rope, new_ckv, new_kr, cache, cur):
        g, chunk = merge_over(cache, 'ckv')
        return decode_mla_reference(q_lat, q_rope, new_ckv, new_kr, cache,
                                    cur, groups=g, chunk=chunk)

    return {'decode_attn': decode_attn, 'decode_mla': decode_mla}
