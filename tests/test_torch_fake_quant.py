"""Fake quantization of the port against the JAX package: the two-pass
kernel's plain version, ``ops.fake_quant``'s routing and the STE over the
kernels.

The same numpy weights go through the reference's Pallas kernels
(interpret mode on the CPU) and the port's wrappers, which run their plain
versions for CPU tensors.  Tolerance: none, the outputs are compared bit
for bit in fp32 and in bf16 (an abs-max and a per-element quantize do not
depend on summation order; both packages upcast bf16 to fp32, compute, and
round the result back to nearest even).  The kernels themselves are held
against these plain versions on a card by tests/test_torch_gpu.py; here the
CUDA cluster kernel's launch plan (``fused_plan``), which both wrappers
launch, is checked as the card runs it, and a torch emulation of its
cluster split (each block's partial column maxima over its rows, merged
across the cluster) is held bit for bit against the reference's
``fake_quant_fused`` and, on the two-pass wrapper's shapes, against its
two-pass ``fake_quant``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels.fake_quant import fake_quant as j_fake_quant
from repro.kernels.fake_quant import fake_quant_fused as j_fake_quant_fused
from repro_torch.core import quantization as tq
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.kernels import counts, ops, reset_counts
from repro_torch.kernels.fake_quant import FUSED_BNS, fake_quant_fused
from repro_torch.kernels.fake_quant import fake_quant as t_fake_quant
from repro_torch.kernels.fake_quant import STATIC_SMEM, fused_plan
from repro_torch.kernels.ref import recip32
from repro_torch.kernels.tiling import SMEM_BUDGET

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


# tinyllama's fused weights (2048, N), its MLP wo, ragged and narrow heads,
# a tall head that fits no shared memory, and degenerate shapes
PLAN_SHAPES = [(2048, 5632), (2048, 2048), (2048, 256), (5632, 2048),
               (1000, 77), (40, 13), (100000, 10), (8192, 100), (7, 3),
               (1, 1), (333, 1000)]


@pytest.mark.parametrize('elem_bytes', [2, 4])
@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_fused_plan_covers_every_element_once(shape, elem_bytes):
    """Stripes of BN columns and the C blocks' row ranges [r*R, (r+1)*R)
    cover the (K, N) weight exactly once; the slice fits the shared memory
    the plan asks for, and that fits an H100 block; clusters stay within
    the portable 8, unless K is so tall that 8 blocks cannot stage
    128-byte stripe rows in the static shared memory: then within 16."""
    K, N = shape
    bn, c, r, smem, staged = fused_plan(K, N, elem_bytes)
    tall = -(-K // 8) * 128 + 8 * (128 // elem_bytes) > STATIC_SMEM
    assert bn in FUSED_BNS and 256 % bn == 0
    assert c in (1, 2, 4, 8) or (tall and c == 16)
    rows = np.zeros(K, int)
    for rank in range(c):
        rows[rank * r:min((rank + 1) * r, K)] += 1
    cols = np.zeros(N, int)
    for j in range(-(-N // bn)):
        cols[j * bn:min((j + 1) * bn, N)] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert 8 * bn + (r * bn * elem_bytes if staged else 0) <= smem
    assert smem <= SMEM_BUDGET


@pytest.mark.parametrize('elem_bytes', [2, 4])
@pytest.mark.parametrize('shape,least', [((2048, 5632), 132),
                                         ((2048, 2048), 132),
                                         ((2048, 256), 64)])
def test_fused_plan_fills_the_card_at_tinyllama_shapes(shape, least,
                                                       elem_bytes):
    """The Q pass's 132 fused weights a step run at least 132 blocks (64
    at N = 256), where one program a 64-column stripe ran 88, 32 and 4."""
    K, N = shape
    bn, c, _, _, staged = fused_plan(K, N, elem_bytes)
    assert staged and -(-N // bn) * c >= least


def test_fused_plan_walks_a_tall_head_from_device_memory():
    """(100000, 10) fp32 routes to the fused kernel (4 MB, under the
    reference's gate) and no slice of it fits shared memory."""
    K, N = 100000, 10
    reset_counts()
    ops.fake_quant(torch.zeros((K, N)), 8)
    assert counts()['fake_quant_fused']['plain_calls'] == 1
    bn, c, r, smem, staged = fused_plan(K, N, 4)
    assert not staged and smem == 8 * bn and r * c >= K


def _emulate_fused(w, bits):
    """The cluster kernel's algorithm on the plan the card would run: each
    block's column maxima over its rows, the max of the cluster's
    partials, then each block quantizes its own rows."""
    K, N = w.shape
    bn, c, r, _, _ = fused_plan(K, N, w.element_size())
    qmax = 2.0 ** (bits - 1) - 1.0
    wf = w.float()
    out = torch.empty_like(w)
    for j in range(0, N, bn):
        blocks = [wf[k * r:(k + 1) * r, j:j + bn] for k in range(c)]
        partial = torch.stack([b.abs().amax(0) if b.shape[0] else
                               torch.zeros(b.shape[1]) for b in blocks])
        scale = torch.clamp_min(partial.amax(0), 1e-8) * recip32(qmax)
        for k, b in enumerate(blocks):
            q = torch.clamp(torch.round(b / scale), -qmax - 1.0, qmax)
            out[k * r:(k + 1) * r, j:j + bn] = (q * scale).to(w.dtype)
    return out


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape,bits', [((40, 13), 8), ((300, 130), 4),
                                        ((1000, 77), 8), ((2048, 256), 2)])
def test_fused_cluster_split_matches_reference_kernel(shape, bits, dtype):
    """Bit for bit against the reference's one-stripe Pallas kernel
    (interpret mode): a max does not depend on how its terms are split."""
    w = _weight(shape, dtype, seed=shape[1] + bits)
    want = j_fake_quant_fused(w, bits=bits, interpret=True)
    tw = from_jax_params(np.asarray(w))
    _assert_same_bits(_emulate_fused(tw, bits), want)
    reset_counts()
    _assert_same_bits(fake_quant_fused(tw, bits=bits), want)
    assert counts()['fake_quant_fused'] == {'launches': 0, 'plain_calls': 1}


# path (f)'s weights on the two-pass wrapper: tinyllama's MLP wo, a ragged
# case and the smallest K the routing sends there
TWO_PASS_SHAPES = [(5632, 2048), (5000, 1000), (4160, 256)]


@pytest.mark.parametrize('elem_bytes', [2, 4])
@pytest.mark.parametrize('shape', TWO_PASS_SHAPES)
def test_two_pass_plan_covers_every_element_once(shape, elem_bytes):
    """The two-pass wrapper launches the cluster kernel on fused_plan: at
    path (f)'s shapes its stripes and the C blocks' slices cover the
    weight exactly once, every slice is staged in shared memory without
    the opt-in (w is read once), the clusters are 16 (K is tall) and the
    grid fills the card; tinyllama's MLP wo in bf16 is 64-column stripes
    (128 bytes a row) on clusters of 16, 352-row slices, 512 blocks."""
    K, N = shape
    bn, c, r, smem, staged = fused_plan(K, N, elem_bytes)
    count = np.zeros((K, N), np.int8)
    for j in range(-(-N // bn)):
        for rank in range(c):
            count[rank * r:(rank + 1) * r, j * bn:(j + 1) * bn] += 1
    assert (count == 1).all()
    assert staged and 8 * bn + r * bn * elem_bytes <= smem <= 48 * 1024
    assert c == 16 and 256 % bn == 0
    assert -(-N // bn) * c >= 132 or N <= 256
    if shape == (5632, 2048):
        assert (bn * elem_bytes, c, r) == (128, 16, 352)


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape,bits', [((4160, 256), 8), ((4160, 256), 2)])
def test_two_pass_cluster_split_matches_reference_kernels(shape, bits, dtype):
    """The cluster kernel's algorithm on the two-pass wrapper's plan (16
    blocks a cluster), bit for bit against the reference's two Pallas
    passes (interpret mode)."""
    w = _weight(shape, dtype, seed=shape[0] + 3 * bits)
    want = j_fake_quant(w, bits=bits, bk=128, interpret=True)
    assert fused_plan(*shape, 2 if dtype == 'bf16' else 4)[1] == 16
    _assert_same_bits(_emulate_fused(from_jax_params(np.asarray(w)), bits),
                      want)
