"""Decode-attention parity of the PyTorch port against the JAX package.

The same numpy inputs go through the reference's Pallas ``decode_attention``
/ ``decode_attention_int8`` (interpret mode on the CPU, as
tests/test_kernels.py runs them), its ``ref.decode_attention_ref``, and the
port's wrappers, which run their plain versions for CPU tensors.  GQA
groups 1, 2 and 4, an S that no power-of-two tile divides, a prefix mask
and a mask with a hole.  Tolerance: fp32 within 1e-5 x max|reference| (the
softmax and both products sum in other orders); bf16 output within 8e-3 x
max|reference|, about one bf16 ulp.  The CUDA kernels themselves are held
against the plain versions on a card by tests/test_torch_gpu.py; here the
kernel's split of S over a cluster (``split_plan``, for 1-, 2- and 4-byte
caches) is checked as the card runs it, and a torch emulation of that
split (each block's softmax over its slots with the int8 scales folded,
the blocks' partials merged as the cluster merges them) is held against
the reference's Pallas kernels and the plain versions.

One difference is by design: a row with no valid slot comes out of the
kernels (TPU and port alike) as the mean of v over the S slots, and out of
the model's ``decode_attn_reference`` as zeros.  No decode step makes such
a row: the token just written is always valid.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ml_dtypes import bfloat16

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.decode_attention import \
    decode_attention_int8 as j_decode_int8
from repro.models import attention as jattn
from repro_torch.kernels import counts, ops, ref, reset_counts
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_GROUP,
                                                  NEG_INF, _scale,
                                                  decode_attention_int8_plain,
                                                  decode_attention_plain,
                                                  group_pad, split_plan,
                                                  split_smem_bytes)
from repro_torch.kernels.tiling import SMEM_BUDGET
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

# (B, H, K, D, S): groups 1, 2 and 4; S = 37 and 100 have no power-of-two
# tile, 584 is the served cache of prompt 512 + 64 tokens + 8
CASES = [(2, 4, 4, 32, 37), (1, 4, 2, 64, 100), (2, 8, 2, 32, 64),
         (1, 8, 2, 64, 584)]
# the int8 cache at the widest head_dim and group the kernel takes
WIDEST_INT8 = dict(elem=1, D=max(HEAD_DIMS), G=MAX_GROUP)


def _mask(S, kind):
    valid = np.zeros(S, bool)
    if kind == 'prefix':
        valid[:S * 3 // 4] = True
    else:                            # a prefix with a hole in it
        valid[:S - 3] = True
        valid[S // 3:S // 3 + 5] = False
    return valid


def _inputs(B, H, K, D, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return q, k, v


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


@pytest.mark.parametrize('mask', ['prefix', 'hole'])
@pytest.mark.parametrize('case', CASES)
def test_decode_attention_matches_reference(case, mask):
    B, H, K, D, S = case
    q, k, v = _inputs(*case, seed=S + H)
    valid = _mask(S, mask)
    reset_counts()
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(valid))
    assert counts()['decode_attention'] == {'launches': 0, 'plain_calls': 1}
    pallas = j_decode(q, k, v, valid, s_blk=128, interpret=True)
    oracle = jref.decode_attention_ref(q, k, v,
                                       np.broadcast_to(valid, (B, S)))
    _close(got.numpy(), pallas, 1e-5)
    _close(got.numpy(), oracle, 1e-5)


@pytest.mark.parametrize('mask', ['prefix', 'hole'])
@pytest.mark.parametrize('case', CASES)
def test_decode_attention_int8_matches_reference(case, mask):
    """int8 codes and per-(token, head) scales from the reference's
    ``kv_quantize``; the port dequantizes them in fp32 as the TPU kernel
    does."""
    B, H, K, D, S = case
    q, k, v = _inputs(*case, seed=7 * S + H)
    kq, ks = (np.array(a) for a in jattn.kv_quantize(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jattn.kv_quantize(jnp.asarray(v)))
    valid = _mask(S, mask)
    reset_counts()
    got = ops.decode_attention_int8(*(torch.from_numpy(a) for a in
                                      (q, kq, vq, ks, vs, valid)))
    assert counts()['decode_attention_int8'] == \
        {'launches': 0, 'plain_calls': 1}
    pallas = j_decode_int8(q, kq, vq, ks, vs, valid, s_blk=128,
                           interpret=True)
    _close(got.numpy(), pallas, 1e-5)


def test_decode_attention_bf16_matches_reference():
    """bf16 q/k/v, bf16 output: the kernel's arithmetic is fp32, so the two
    agree to the output's rounding."""
    B, H, K, D, S = 2, 8, 2, 64, 100
    q, k, v = (a.astype(bfloat16) for a in _inputs(B, H, K, D, S, seed=5))
    valid = _mask(S, 'hole')
    t = [torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
         for a in (q, k, v)]
    got = ops.decode_attention(*t, torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    pallas = j_decode(q, k, v, valid, s_blk=128, interpret=True)
    assert pallas.dtype == jnp.bfloat16
    _close(got.float().numpy(), pallas, 8e-3)


def test_decode_attention_ref_matches_reference():
    """The oracle itself (q scaled in its own dtype, a one-shot softmax)."""
    B, H, K, D, S = 2, 8, 4, 32, 50
    q, k, v = _inputs(B, H, K, D, S, seed=3)
    valid = np.random.default_rng(4).random((B, S)) < 0.7
    got = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(valid))
    _close(got.numpy(), jref.decode_attention_ref(q, k, v, valid), 1e-5)


def test_no_valid_slot_gives_the_mean_and_never_arises_in_decode():
    """The one case where the kernels and the model's reference decode math
    differ by design (see the module docstring): the kernels give the mean
    of v, and a decode step never asks for it."""
    B, H, K, D, S = 1, 4, 2, 32, 40
    q, k, v = _inputs(B, H, K, D, S, seed=9)
    none = np.zeros(S, bool)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(none))
    mean = v.mean(axis=1).repeat(H // K, axis=1)       # (B, H, D)
    _close(got.numpy(), mean, 1e-5)
    _close(got.numpy(), j_decode(q, k, v, none, s_blk=8, interpret=True),
           1e-5)
    # the reference math (its max floored at -1e29) would give zeros for
    # that row; a decode step cannot make it, as the written slot is valid
    cache = {'k': jnp.asarray(k), 'v': jnp.asarray(v),
             'meta': {'slots': jnp.arange(S, dtype=jnp.int32),
                      'pos': jnp.full((S,), -1, jnp.int32),
                      'total': jnp.asarray(S, jnp.int32)}}
    out, c = jattn.decode_attn_reference(
        jnp.asarray(q), jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]), cache,
        jnp.asarray(5, jnp.int32))
    assert np.asarray(c['meta']['pos'])[5] == 5      # the written slot
    assert np.abs(np.asarray(out)).max() > 0         # is valid: not zeros


def test_plain_versions_count_their_calls():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 32, 9, seed=1))
    valid = torch.ones(9, dtype=torch.bool)
    reset_counts()
    for _ in range(3):
        ops.decode_attention(q, k, v, valid)
    kq, ks = tattn.kv_quantize(k)
    ops.decode_attention_int8(q, kq, kq, ks, ks, valid)
    assert decode_attention_plain.calls == 3
    assert decode_attention_int8_plain.calls == 1
    c = counts()
    assert c['decode_attention']['launches'] == 0
    assert c['decode_attention_int8']['launches'] == 0


@pytest.mark.parametrize('bks', [(8, 4, 584), (1, 4, 584), (1, 4, 2048),
                                 (8, 4, 2048), (2, 2, 100), (2, 4, 37),
                                 (1, 2, 300), (1, 16, 33), (3, 1, 1)])
def test_split_plan_covers_every_slot_once(bks):
    """The C blocks' slot ranges [r*spb, (r+1)*spb) cover S exactly once
    (ragged S included); clusters stay within the portable 8, a warp for
    each 16 slots of a block up to 8, and every block's shared memory fits
    an H100 block for every head_dim and group the kernel takes."""
    B, K, S = bks
    c, spb, warps = split_plan(B, K, S, **WIDEST_INT8)
    assert 1 <= c <= 8 and 1 <= warps <= 8 and warps * 16 >= min(spb, 128)
    slots = np.zeros(S, int)
    for r in range(c):
        slots[r * spb:min((r + 1) * spb, S)] += 1
    assert (slots == 1).all()
    for D in HEAD_DIMS:
        for g in range(1, MAX_GROUP + 1):
            assert split_smem_bytes(warps, group_pad(g), D, 1) <= \
                SMEM_BUDGET


@pytest.mark.parametrize('elem', [1, 2, 4], ids=['int8', 'bf16', 'fp32'])
@pytest.mark.parametrize('bks', [(8, 4, 584), (1, 4, 584), (8, 4, 2048),
                                 (2, 4, 37), (1, 16, 33), (3, 1, 1)])
def test_split_plan_fits_every_cache_type(elem, bks):
    """The plan for a 1-, 2- or 4-byte cache at every head_dim and group
    the kernel takes: the slot split is the int8 plan's, and the warps are
    the most of the int8 plan's that fit: a block's double-buffered k and
    v rows (2 x 16W x D x bytes each) keep it within an H100 block's
    shared memory."""
    B, K, S = bks
    c8, spb8, w8 = split_plan(B, K, S, **WIDEST_INT8)
    for D in HEAD_DIMS:
        for g in range(1, MAX_GROUP + 1):
            G = group_pad(g)
            c, spb, warps = split_plan(B, K, S, elem=elem, D=D, G=G)
            assert (c, spb) == (c8, spb8) and 1 <= warps <= w8
            assert split_smem_bytes(warps, G, D, elem) <= SMEM_BUDGET
            assert warps == w8 or split_smem_bytes(
                warps + 1, G, D, elem) > SMEM_BUDGET
            if elem == 1:
                assert warps == w8
    assert split_smem_bytes(8, 16, 128, 4) > SMEM_BUDGET
    if w8 >= 6:
        assert split_plan(B, K, S, elem=4, D=128, G=16)[2] == 6


def test_split_plan_fills_the_card_at_tinyllama_shapes():
    """Batch 8 over the served 584-slot cache: 8 blocks of 73 slots for
    each of the 32 (kv head, row) cells, 256 blocks where one block a cell
    ran 32.  Batch 1 keeps the portable cluster of 8: 32 blocks."""
    tl = dict(elem=1, D=64, G=8)      # tinyllama's int8 cache
    assert split_plan(8, 4, 584, **tl) == (8, 73, 5)
    assert 8 * 4 * split_plan(8, 4, 584, **tl)[0] >= 132
    assert split_plan(1, 4, 584, **tl)[0] == 8
    assert split_plan(1, 4, 2048, **tl) == (8, 256, 8)


def _split_emulation(q, kq, vq, ks, vs, valid):
    """The split kernel's algorithm in torch fp32 on the plan the card would
    run: per block, logits ``ks[s] * (q . code)``, -1e30 where masked, a
    softmax around the block's max and ``(p * vs[s]) @ code``; then the
    cluster's merge ``exp(m_r - M)`` over the C blocks.  A bf16 or fp32
    cache has no scales (``ks`` and ``vs`` None): the kernel compiles the
    multiply out, a scale of 1 here."""
    B, H, D = q.shape
    S, K = kq.shape[1], kq.shape[2]
    if ks is None:
        ks = vs = torch.ones((B, S, K))
    g = H // K
    c, spb, _ = split_plan(B, K, S, elem=kq.element_size(), D=D,
                           G=group_pad(g))
    qg = q.float().reshape(B, K, g, D) * _scale(D)
    parts = []
    for r in range(c):
        lo, hi = min(S, r * spb), min(S, (r + 1) * spb)
        dot = torch.einsum('bkgd,bskd->bkgs', qg, kq[:, lo:hi].float())
        logit = ks[:, lo:hi].permute(0, 2, 1)[:, :, None, :] * dot
        logit = torch.where(valid[lo:hi], logit, torch.tensor(NEG_INF))
        m = logit.amax(-1, keepdim=True) if hi > lo else torch.full(
            (B, K, g, 1), NEG_INF)
        p = torch.exp(logit - m)
        pv = p * vs[:, lo:hi].permute(0, 2, 1)[:, :, None, :]
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum('bkgs,bskd->bkgd', pv,
                                   vq[:, lo:hi].float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    A = sum(a * torch.exp(m - M) for m, _, a in parts)
    return (A / torch.clamp_min(L, 1e-30)).reshape(B, H, D).to(q.dtype)


@pytest.mark.parametrize('case,mask', [
    ((1, 4, 2, 32, 300), 'ragged, a hole and a masked block'),
    ((2, 8, 2, 64, 100), 'a prefix leaving the last block masked'),
    ((1, 4, 2, 32, 300), 'no valid slot'),
    ((1, 8, 2, 64, 584), 'prefix')])
def test_split_emulation_matches_reference(case, mask):
    """S = 300 splits into 8 blocks of 38 slots and a ragged 34; S = 100
    into 2 of 50.  fp32 within 1e-5 x max|reference| of the reference's
    Pallas kernel (interpret mode) and the plain version; the row with no
    valid slot is the mean of v in all three."""
    B, H, K, D, S = case
    q, k, v = _inputs(*case, seed=S + D)
    kq, ks = (np.array(a) for a in jattn.kv_quantize(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jattn.kv_quantize(jnp.asarray(v)))
    c, spb, _ = split_plan(B, K, S, elem=1, D=D, G=group_pad(H // K))
    valid = np.zeros(S, bool)
    if mask.startswith('ragged'):
        valid[:S - 5] = True
        valid[spb:2 * spb] = False                 # block 1 wholly masked
        valid[S // 2:S // 2 + 3] = False
    elif mask.startswith('a prefix'):
        valid[:spb * (c - 1) - 7] = True           # the last block masked
    elif mask == 'prefix':
        valid[:513] = True
    assert c > 1
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, valid)]
    got = _split_emulation(*t)
    pallas = j_decode_int8(q, kq, vq, ks, vs, valid, s_blk=128,
                           interpret=True)
    _close(got.numpy(), pallas, 1e-5)
    _close(got.numpy(), decode_attention_int8_plain(*t).numpy(), 1e-5)
    if not valid.any():
        mean = (vq.astype(np.float32) * vs[..., None]).mean(axis=1)
        _close(got.numpy(), mean.repeat(H // K, axis=1), 1e-5)


@pytest.mark.parametrize('mask', ['hole and a masked block', 'no valid slot'])
def test_split_emulation_float_cache_matches_reference(mask):
    """The same split over an fp32 cache (D = 128, group 4, S = 300 in 8
    blocks of 38 and a ragged 34), within 1e-5 x max|reference| of the
    reference's Pallas ``decode_attention`` (interpret mode) and the plain
    version."""
    B, H, K, D, S = 1, 8, 2, 128, 300
    q, k, v = _inputs(B, H, K, D, S, seed=11)
    c, spb, _ = split_plan(B, K, S, elem=4, D=D, G=H // K)
    assert c == 8
    valid = np.zeros(S, bool)
    if mask != 'no valid slot':
        valid[:S - 5] = True
        valid[spb:2 * spb] = False
        valid[S // 2:S // 2 + 3] = False
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = _split_emulation(t[0], t[1], t[2], None, None,
                           torch.from_numpy(valid))
    pallas = j_decode(q, k, v, valid, s_blk=128, interpret=True)
    _close(got.numpy(), pallas, 1e-5)
    _close(got.numpy(), decode_attention_plain(
        *t, torch.from_numpy(valid)).numpy(), 1e-5)


def _reference_decode(q, k, v, valid, cap, kv_bits):
    """The reference model's ``decode_attn_reference`` under ``jax.jit``
    over a cache whose slot s holds position s (or -1 where ``valid`` is
    false), at the last valid position: the written k/v are the slot's
    own, so the write changes nothing.  Returns (out, the int8 cache's
    codes and scales or None)."""
    B, S, K, D = k.shape
    cur = int(np.nonzero(valid)[0].max())
    cache = {'meta': {'slots': jnp.arange(S, dtype=jnp.int32),
                      'pos': jnp.asarray(np.where(valid, np.arange(S), -1),
                                         jnp.int32),
                      'total': jnp.asarray(S, jnp.int32)}}
    if kv_bits:
        kq, ks = jattn.kv_quantize(jnp.asarray(k))
        vq, vs = jattn.kv_quantize(jnp.asarray(v))
        cache.update(k=kq, v=vq, k_s=ks, v_s=vs)
        nk = jattn.kv_dequantize(kq, ks, jnp.float32)[:, cur]
        nv = jattn.kv_dequantize(vq, vs, jnp.float32)[:, cur]
        quant = tuple(np.array(a) for a in (kq, vq, ks, vs))
    else:
        cache.update(k=jnp.asarray(k), v=jnp.asarray(v))
        nk, nv, quant = jnp.asarray(k[:, cur]), jnp.asarray(v[:, cur]), None

    @jax.jit
    def run(q, nk, nv, cache):
        return jattn.decode_attn_reference(
            q, nk, nv, cache, jnp.asarray(cur, jnp.int32),
            attn_softcap=cap)[0]
    return np.asarray(run(jnp.asarray(q), nk, nv, cache)), quant


@pytest.mark.parametrize('kv_bits', [0, 8])
@pytest.mark.parametrize('cap', [50.0, 1.0])
@pytest.mark.parametrize('case', [(2, 4, 2, 256, 37), (1, 8, 4, 256, 100),
                                  (2, 8, 2, 64, 100)])
def test_plain_softcap_matches_the_jitted_reference(case, cap, kv_bits):
    """Both plain versions with the attention softcap, at head_dim 256
    (gemma2's) and 64, against ``jax.jit`` of the reference model's decode
    math, with a hole in the mask: the cap applies before the mask, so a
    masked slot keeps -1e30 (cap 1 would show a masked slot given -cap:
    its weight exp(-1 - m) is not negligible).  fp32 within 1e-5 x
    max|reference|.  The int8 cache holds the reference's own codes."""
    B, H, K, D, S = case
    q, k, v = _inputs(*case, seed=S + D + int(cap))
    valid = _mask(S, 'hole')
    want, quant = _reference_decode(q, k, v, valid, cap, kv_bits)
    tv = torch.from_numpy(valid)
    if kv_bits:
        got = decode_attention_int8_plain(
            torch.from_numpy(q), *(torch.from_numpy(a) for a in quant), tv,
            attn_softcap=cap)
    else:
        got = decode_attention_plain(*(torch.from_numpy(a) for a in
                                       (q, k, v)), tv, attn_softcap=cap)
    _close(got.numpy(), want, 1e-5)
    if cap == 1.0 and not kv_bits:   # the same over the valid slots alone
        keep = np.nonzero(valid)[0]
        sub = decode_attention_plain(
            torch.from_numpy(q), torch.from_numpy(k[:, keep]),
            torch.from_numpy(v[:, keep]), torch.ones(len(keep), dtype=bool),
            attn_softcap=cap)
        _close(sub.numpy(), want, 1e-5)


def test_plain_softcap_with_no_valid_slot_is_the_mean_of_v():
    """Under the softcap too, a row with no valid slot comes out of the
    kernels' function as the mean of v (every slot -1e30, as without
    the cap); the reference's decode math would give zeros, and no decode
    step makes such a row."""
    B, H, K, D, S = 1, 4, 2, 256, 40
    q, k, v = _inputs(B, H, K, D, S, seed=13)
    none = torch.zeros(S, dtype=torch.bool)
    got = decode_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                 none, attn_softcap=50.0)
    _close(got.numpy(), v.mean(axis=1).repeat(H // K, axis=1), 1e-5)
    kq, ks = tattn.kv_quantize(torch.from_numpy(k))
    vq, vs = tattn.kv_quantize(torch.from_numpy(v))
    got = decode_attention_int8_plain(torch.from_numpy(q), kq, vq, ks, vs,
                                      none, attn_softcap=50.0)
    mean = (vq.float() * vs[..., None]).mean(1).repeat_interleave(H // K, 1)
    _close(got.numpy(), mean.numpy(), 1e-5)


def test_split_plan_at_gemma2_decode_shape():
    """gemma2-9b's decode call, (B, H, K, D, S) = (8, 16, 8, 256, 584),
    group 2: 64 (kv head, row) cells, clusters of 4 blocks of 146 slots;
    the warps the most that fit under SMEM_BUDGET for each cache (a bf16
    row pair 32 KB a warp: 6; fp32: 3; int8: all 8 the slots ask for is
    more than 146 / 16 rounds up to, so 8 is not reached: 8)."""
    plans = {e: split_plan(8, 8, 584, elem=e, D=256, G=2) for e in (1, 2, 4)}
    assert plans[2] == (4, 146, 6) and plans[4] == (4, 146, 3)
    assert plans[1] == (4, 146, 8)
    for e, (c, spb, w) in plans.items():
        assert split_smem_bytes(w, 2, 256, e) <= SMEM_BUDGET
        if w < 8:
            assert split_smem_bytes(w + 1, 2, 256, e) > SMEM_BUDGET
    # the group and head_dim the kernel is instantiated for: gemma2's
    # group of 2 in one block; a head_dim or a group it has no
    # instantiation for is refused
    from repro_torch.kernels.decode_attention import (MAX_GROUP_X_D, _check,
                                                      group_split)
    assert 256 in HEAD_DIMS and group_pad(2) * 256 <= MAX_GROUP_X_D
    assert group_split(2, 256) == (2, 1)
    for H, D in ((16, 96), (17, 64)):
        q = torch.zeros((1, H, D))
        kv = torch.zeros((1, 4, 1, D))
        with pytest.raises(ValueError, match='head_dim'):
            _check('decode_attention', q, torch.float32, (kv, kv), (),
                   torch.ones(4, dtype=torch.bool))


def test_phase_script_finds_every_stamp_marker():
    """scripts/split_kernel_phases.py times the split kernel's phases on a
    card by inserting stamps after marker lines of the CUDA source; every
    marker still occurs exactly once."""
    path = os.path.join(os.path.dirname(__file__), '..', 'scripts',
                        'split_kernel_phases.py')
    spec = importlib.util.spec_from_file_location('split_kernel_phases', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    src = module.instrumented_source()
    assert all(src.count(f'STAMP({i});') == 1 for i in range(7))
