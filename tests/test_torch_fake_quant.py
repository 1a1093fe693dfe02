"""Fake quantization of the port against the JAX package: the two-pass
kernel's plain version, ``ops.fake_quant``'s routing and the STE over the
kernels.

The same numpy weights go through the reference's Pallas kernels
(interpret mode on the CPU) and the port's wrappers, which run their plain
versions for CPU tensors.  Tolerance: none, the outputs are compared bit
for bit in fp32 and in bf16 (an abs-max and a per-element quantize do not
depend on summation order; both packages upcast bf16 to fp32, compute, and
round the result back to nearest even).  The Triton kernels themselves are
held against these plain versions on a card by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels.fake_quant import fake_quant as j_fake_quant
from repro_torch.core import quantization as tq
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.kernels import counts, ops, reset_counts
from repro_torch.kernels.fake_quant import fake_quant as t_fake_quant

torch.set_num_threads(1)

DTYPES = {'fp32': jnp.float32, 'bf16': jnp.bfloat16}


def _weight(shape, dtype, seed=0):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(w).astype(DTYPES[dtype])


def _bits(a):
    """The raw bits of an fp32 or bf16 array, for an exact comparison."""
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_same_bits(port, ref):
    port = to_numpy(port)
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(_bits(port), _bits(ref))


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape,bits', [((384, 200), 8), ((300, 130), 8),
                                        ((300, 130), 4), ((4160, 256), 8)])
def test_two_pass_plain_matches_reference_kernels(shape, bits, dtype):
    """(384, 200): three K tiles of bk=128; (300, 130): ragged in both dims;
    (4160, 256): the smallest K the routing sends to the two-pass pair."""
    w = _weight(shape, dtype, seed=shape[0] + bits)
    want = j_fake_quant(w, bits=bits, bk=128, interpret=True)
    reset_counts()
    got = t_fake_quant(from_jax_params(np.asarray(w)), bits=bits)
    assert counts()['fake_quant'] == {'launches': 0, 'plain_calls': 1}
    _assert_same_bits(got, want)


@pytest.mark.parametrize('dtype,shape', [('bf16', (512, 384)),
                                         ('fp32', (512, 384)),
                                         ('bf16', (4160, 256))])
def test_ops_fake_quant_matches_reference(dtype, shape):
    """The bf16 repair: the port used to quantize a bf16 weight in bf16
    arithmetic, and differed from the reference's kernels (fp32 math) at a
    third of the elements of the (512, 384) weight."""
    w = _weight(shape, dtype)
    want = jops.fake_quant(w, 8)
    got = ops.fake_quant(from_jax_params(np.asarray(w)), 8)
    _assert_same_bits(got, want)


@pytest.mark.parametrize('shape,kernel', [((2048, 5632), 'fake_quant_fused'),
                                          ((5632, 2048), 'fake_quant'),
                                          ((4096, 256), 'fake_quant_fused'),
                                          ((4097, 256), 'fake_quant'),
                                          ((8192, 100), 'fake_quant_fused')])
def test_fake_quant_routes_as_the_reference(monkeypatch, shape, kernel):
    """tinyllama's attention and MLP input weights (2048, *) take the fused
    kernel, its MLP ``wo`` (5632, 2048) the two-pass pair, in both packages
    (the reference's kernels are stubbed to record the choice)."""
    took = []
    monkeypatch.setattr(jops, '_pallas_fq_fused',
                        lambda w, **kw: took.append('fake_quant_fused'))
    monkeypatch.setattr(jops, '_pallas_fake_quant',
                        lambda w, **kw: took.append('fake_quant'))
    jops.fake_quant(jnp.zeros(shape, jnp.bfloat16), 8)
    assert took == [kernel]
    reset_counts()
    ops.fake_quant(torch.zeros(shape, dtype=torch.bfloat16), 8)
    ran = {k for k, c in counts().items() if c['plain_calls']}
    assert ran == {kernel}


@pytest.mark.parametrize('dtype,shape', [('fp32', (40, 13)),
                                         ('bf16', (40, 13)),
                                         ('bf16', (4160, 256))])
def test_kernel_ste_matches_reference(dtype, shape):
    """The STE over the kernels: forward bit for bit against the reference's
    ``fake_quant_weight(use_kernel=True)``, in w's dtype; the gradient of
    ``sum(c * fq(w))`` is ``c`` (the identity backward) in both."""
    w = _weight(shape, dtype, seed=7)
    c = _weight(shape, dtype, seed=8)

    def j_obj(w):
        return jnp.sum(c.astype(jnp.float32) * jq.fake_quant_weight(
            w, 8, use_kernel=True).astype(jnp.float32))

    want_fq = jq.fake_quant_weight(w, 8, use_kernel=True)
    want_g = jax.grad(j_obj)(w)
    tw = from_jax_params(np.asarray(w)).requires_grad_()
    tc = from_jax_params(np.asarray(c)).to(torch.float32)
    reset_counts()
    got_fq = tq.fake_quant_weight(tw, 8, use_kernel=True)
    assert sum(v['plain_calls'] for v in counts().values()) == 1
    assert got_fq.dtype == tw.dtype
    (tc * got_fq.to(torch.float32)).sum().backward()
    _assert_same_bits(got_fq.detach(), want_fq)
    _assert_same_bits(tw.grad, want_g)
