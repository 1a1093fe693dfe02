"""Decode-attention parity of the PyTorch port against the JAX package.

The same numpy inputs go through the reference's Pallas ``decode_attention``
/ ``decode_attention_int8`` (interpret mode on the CPU, as
tests/test_kernels.py runs them), its ``ref.decode_attention_ref``, and the
port's wrappers, which run their plain versions for CPU tensors.  GQA
groups 1, 2 and 4, an S that no power-of-two tile divides, a prefix mask
and a mask with a hole.  Tolerance: fp32 within 1e-5 x max|reference| (the
softmax and both products sum in other orders); bf16 output within 8e-3 x
max|reference|, about one bf16 ulp.  The CUDA kernels themselves are held
against the plain versions on a card by tests/test_torch_gpu.py.

One difference is by design: a row with no valid slot comes out of the
kernels (TPU and port alike) as the mean of v over the S slots, and out of
the model's ``decode_attn_reference`` as zeros.  No decode step makes such
a row: the token just written is always valid.
"""
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
from repro_torch.kernels.decode_attention import (decode_attention_int8_plain,
                                                  decode_attention_plain)
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

# (B, H, K, D, S): groups 1, 2 and 4; S = 37 and 100 have no power-of-two
# tile, 584 is the served cache of prompt 512 + 64 tokens + 8
CASES = [(2, 4, 4, 32, 37), (1, 4, 2, 64, 100), (2, 8, 2, 32, 64),
         (1, 8, 2, 64, 584)]


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
