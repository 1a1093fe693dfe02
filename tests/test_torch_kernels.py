"""Kernel-level parity of the PyTorch port against the JAX package.

The same numpy inputs go through the reference's Pallas kernels (interpret
mode on the CPU, ``use_pallas=True``) and the port's kernel wrappers, which
run their plain versions for CPU tensors.  Tolerances: int8 codes must be
identical; fp32 outputs within rtol 1e-6 (XLA may contract
``acc * scale + bias`` into an FMA inside jit, torch eager does not, so
fp32 results can differ by an ulp); fake quant and the weight quantizer
bit-exact.  The kernels themselves are held against their plain versions
on a card by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fake_quant import fake_quant_fused as j_fake_quant_fused
from repro.kernels.lowrank_conv import fits_fused as j_fits_fused
from repro.kernels.quant_conv import im2col_nhwc as j_im2col
from repro.kernels import tiling as jtiling
from repro_torch.core import quantization as tq
from repro_torch.kernels import _build, counts, ops, ref, reset_counts, tiling
from repro_torch.kernels.lowrank_conv import (LAUNCH_US, fits_fused,
                                              lowering_costs, lr_plan)
from repro_torch.kernels.quant_conv import im2col_nhwc

torch.set_num_threads(1)


def _i8(rng, *shape):
    return rng.integers(-128, 128, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_same(port, jax_out):
    port = port.numpy()
    jax_out = np.asarray(jax_out)
    assert port.dtype == jax_out.dtype and port.shape == jax_out.shape
    if port.dtype == np.int8:
        np.testing.assert_array_equal(port, jax_out)
    else:
        np.testing.assert_allclose(port, jax_out, rtol=1e-6, atol=1e-6)


EPILOGUES = [dict(), dict(bias=True, relu=True),
             dict(bias=True, out_scale=0.37), dict(relu=True, out_scale=1.3)]


@pytest.mark.parametrize('mkn', [(37, 27, 13), (9, 64, 5), (16, 33, 128)])
@pytest.mark.parametrize('epi', range(len(EPILOGUES)))
def test_quant_matmul_matches_reference(mkn, epi):
    m, k, n = mkn
    rng = np.random.default_rng(m * 100 + k + epi)
    x, w = _i8(rng, m, k), _i8(rng, k, n)
    sx = (rng.random(m) * 1e-2).astype(np.float32)
    sw = (rng.random(n) * 1e-2).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    e = dict(EPILOGUES[epi])
    bias = b if e.pop('bias', False) else None
    want = jops.quant_matmul(x, w, sx, sw, bias, use_pallas=True, **e)
    got = ops.quant_matmul(_t(x), _t(w), _t(sx), _t(sw),
                           None if bias is None else _t(bias), **e)
    _assert_same(got, want)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('case', [
    dict(shape=(2, 7, 8, 3), k=3, cout=5, out_scale=0.5, relu=True),
    dict(shape=(1, 8, 8, 4), k=3, cout=6, out_scale=None, relu=False,
         bias=False),
    dict(shape=(2, 6, 5, 3), k=1, cout=4, out_scale=0.2, relu=False)])
def test_quant_conv_matches_reference(stride, case):
    rng = np.random.default_rng(7 + stride)
    x = _i8(rng, *case['shape'])
    w = _i8(rng, case['k'], case['k'], case['shape'][-1], case['cout'])
    sw = (rng.random(case['cout']) * 1e-2).astype(np.float32)
    b = rng.standard_normal(case['cout']).astype(np.float32)
    kw = dict(sx=0.05, stride=stride, relu=case['relu'],
              out_scale=case['out_scale'])
    if not case.get('bias', True):
        b = None
    want = jops.quant_conv_static(x, w, sw, b, use_pallas=True, **kw)
    got = ops.quant_conv_static(_t(x), _t(w), _t(sw),
                                None if b is None else _t(b), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize('stride', [1, 2])
def test_quant_conv_ref_matches_reference(stride):
    """The fp32-conv oracle (dequantize, then a SAME conv): rtol 1e-5, as
    XLA and torch order the conv's fp32 sums differently."""
    rng = np.random.default_rng(11 + stride)
    x, w = _i8(rng, 2, 8, 7, 3), _i8(rng, 3, 3, 3, 5)
    sw = (rng.random(5) * 1e-2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jref.quant_conv_ref(jnp.asarray(x), jnp.asarray(w), 0.05,
                               jnp.asarray(sw), jnp.asarray(b),
                               stride=stride, relu=True)
    got = ref.quant_conv_ref(_t(x), _t(w), 0.05, _t(sw), _t(b),
                             stride=stride, relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the int8 kernel path computes the same conv up to fp32 rounding
    np.testing.assert_allclose(
        ops.quant_conv_static(_t(x), _t(w), _t(sw), _t(b), sx=0.05,
                              stride=stride, relu=True).numpy(),
        got.numpy(), rtol=1e-5, atol=1e-5)


DW_CASES = [
    dict(shape=(2, 7, 9, 5), mult=1, bias=True, relu=True, out_scale=0.5),
    dict(shape=(1, 8, 8, 6), mult=2, bias=False, relu=False, out_scale=None),
    dict(shape=(2, 6, 5, 8), mult=1, bias=True, relu=False, out_scale=None),
    dict(shape=(1, 5, 6, 3), mult=2, bias=True, relu=True, out_scale=1.3),
    dict(shape=(2, 8, 8, 16), mult=2, bias=True, relu=True, out_scale=0.37)]


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('case', range(len(DW_CASES)))
def test_depthwise_conv_matches_reference(stride, case):
    """Odd H and W, COUT not a multiple of 8, a channel multiplier of 2,
    with and without bias, ReLU and the int8 requantize epilogue; the last
    case (CIN and COUT multiples of 16, a multiplier, an even plane, so
    the (0, 1) SAME pad at stride 2) has the shapes the CUDA tile route
    takes."""
    c = DW_CASES[case]
    rng = np.random.default_rng(31 + 2 * case + stride)
    n = c['shape'][-1] * c['mult']
    x, w = _i8(rng, *c['shape']), _i8(rng, 3, 3, 1, n)
    sw = (rng.random(n) * 1e-2).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if c['bias'] else None
    kw = dict(sx=0.05, stride=stride, relu=c['relu'],
              out_scale=c['out_scale'])
    want = jops.depthwise_conv_static(x, w, sw, b, use_pallas=True, **kw)
    got = ops.depthwise_conv_static(_t(x), _t(w), _t(sw),
                                    None if b is None else _t(b), **kw)
    _assert_same(got, want)


LR_CASES = [dict(shape=(2, 7, 8, 6), k=3, r=5, cout=13, out_scale=0.37),
            dict(shape=(1, 8, 8, 16), k=3, r=30, cout=20, out_scale=None),
            dict(shape=(2, 5, 6, 8), k=1, r=12, cout=10, out_scale=1.3)]


def _lr_operands(case, seed):
    c = LR_CASES[case]
    rng = np.random.default_rng(seed)
    r, n = c['r'], c['cout']
    return (_i8(rng, *c['shape']), _i8(rng, c['k'], c['k'], c['shape'][-1], r),
            _i8(rng, 1, 1, r, n), (rng.random(r) * 1e-2).astype(np.float32),
            (rng.random(n) * 1e-2).astype(np.float32),
            rng.standard_normal(r).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('case', range(len(LR_CASES)))
def test_lowrank_conv_matches_reference(stride, case):
    """Rank not a multiple of 8, ragged COUT, stride 2, ReLU, int8 and
    fp32 outputs, against the reference's fused Pallas kernel."""
    ops_ = _lr_operands(case, 41 + 2 * case + stride)
    kw = dict(sx=0.05, h_scale=0.9, stride=stride, relu=case != 1,
              out_scale=LR_CASES[case]['out_scale'])
    want = jops.lowrank_conv_nhwc(*ops_, use_pallas=True, **kw)
    got = ops.lowrank_conv_nhwc(*map(_t, ops_), **kw)
    _assert_same(got, want)


@pytest.mark.parametrize('out_scale', [None, 0.37])
def test_lowrank_plain_equals_chained_pair(out_scale):
    """The fused plain version is the port's chained pair, bit for bit."""
    x, u, v, su, sv, bu, bv = map(_t, _lr_operands(0, 5))
    fused = ops.lowrank_conv_nhwc(x, u, v, su, sv, bu, bv, sx=0.05,
                                  h_scale=0.9, stride=2, relu=True,
                                  out_scale=out_scale)
    h = ops.quant_conv_static(x, u, su, bu, sx=0.05, stride=2,
                              out_scale=0.9)
    chained = ops.quant_conv_static(h, v, sv, bv, sx=0.9, relu=True,
                                    out_scale=out_scale)
    if fused.dtype == torch.float32:
        fused, chained = fused.view(torch.int32), chained.view(torch.int32)
    assert torch.equal(fused, chained)


def test_fits_fused_matches_reference():
    for r in (1, 7, 30, 64, 127, 128, 129, 206, 300):
        for cout in (10, 64, 512):
            assert fits_fused(r, cout) == j_fits_fused(r, cout), (r, cout)


def test_lowering_costs_price_the_h100_kernels():
    """Same MACs either way; the chained pair moves h through device memory
    and pays a second launch, so it is never the cheaper one here."""
    for m, k1, r, n in [(32768, 576, 30, 64), (2048, 2304, 118, 256),
                        (512, 256, 40, 512)]:
        c = lowering_costs(m, k1, r, n)
        assert c['chained_bytes'] - c['fused_bytes'] == 2 * m * r
        assert c['fused_us'] < c['chained_us']
        assert c['macs'] == m * r * (k1 + n)
    cheap = lowering_costs(2048, 2304, 118, 256, launch_us=0.0)
    assert cheap['chained_us'] - cheap['fused_us'] < \
        lowering_costs(2048, 2304, 118, 256)['chained_us'] - \
        lowering_costs(2048, 2304, 118, 256)['fused_us']
    # the fused kernel's tensor cores run the plan's rank tile, not 128:
    # rank 30 pays for 32 columns, rank 118 for 128
    for m, k1, r, n, rp in [(32768, 576, 30, 64, 32),
                            (8192, 1152, 59, 128, 64),
                            (512, 256, 82, 512, 96),
                            (2048, 2304, 118, 256, 128)]:
        c = lowering_costs(m, k1, r, n)
        assert lr_plan(m, k1, r, n)[1] == rp
        assert c['fused_macs'] == m * rp * (k1 + n)
        assert c['fused_us'] == pytest.approx(
            LAUNCH_US + max(c['fused_macs'] / 989.5e6,
                            c['fused_bytes'] / 3.35e6))


@pytest.mark.parametrize('geom', [((2, 7, 8, 3), 3, 2), ((1, 8, 8, 2), 3, 1),
                                  ((2, 5, 6, 3), 1, 2)])
def test_im2col_matches_reference(geom):
    shape, k, stride = geom
    x = _i8(np.random.default_rng(3), *shape)
    want, hw = j_im2col(jnp.asarray(x), k, k, stride)
    got, hw2 = im2col_nhwc(_t(x), k, k, stride)
    assert hw == hw2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('bits', [2, 4, 8])
def test_fake_quant_fused_matches_reference(bits):
    w = np.random.default_rng(bits).standard_normal((40, 13)).astype(
        np.float32)
    want = j_fake_quant_fused(jnp.asarray(w), bits=bits, interpret=True)
    got = ops.fake_quant(_t(w), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_scales(got, want, bits, maxulp):
    """Bit-exact for bits >= 2 (an abs-max is order-free).  The bits=1
    DoReFa scale is a mean, which XLA and torch sum in different fp32
    orders (a few ulps over tens of terms): held to ``maxulp`` units in
    the last place."""
    got, want = np.asarray(got), np.asarray(want)
    if bits == 1:
        np.testing.assert_array_max_ulp(got, want, maxulp=maxulp)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('bits', [1, 2, 4, 8])
@pytest.mark.parametrize('shape', [(3, 3, 4, 6), (12, 7)])
def test_quantize_weight_matches_reference(bits, shape):
    w = np.random.default_rng(bits).standard_normal(shape).astype(np.float32)
    q_want, s_want = jq.quantize_weight(jnp.asarray(w), bits, axis=-1)
    q_got, s_got = tq.quantize_weight(_t(w), bits, axis=-1)
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    _assert_scales(s_got.numpy(), s_want, bits, maxulp=4)
    fq_want = jq.fake_quant_weight(jnp.asarray(w), bits, axis=-1)
    fq_got = tq.fake_quant_weight(_t(w), bits, axis=-1)
    _assert_scales(fq_got.numpy(), fq_want, bits, maxulp=4)


@pytest.mark.parametrize('bits', [1, 2, 4, 8])
def test_quantize_params_for_serving_matches_reference(bits):
    rng = np.random.default_rng(bits)
    tree = {'stem': {'w': rng.standard_normal((3, 3, 3, 8)),
                     'b': rng.standard_normal(8)},
            'stages': [[{'conv1': {'w': rng.standard_normal((1, 1, 8, 4))},
                         'n1': {'scale': np.ones(4)}}]],
            'head': {'w': rng.standard_normal((4, 10)),
                     'b': np.zeros(10)}}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    want = jq.quantize_params_for_serving(
        jax.tree.map(jnp.asarray, tree), bits=bits)
    from repro_torch.interop import from_jax_params, to_numpy
    got = to_numpy(tq.quantize_params_for_serving(from_jax_params(tree),
                                                  bits=bits))
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for a, b in zip(flat_w, flat_g):
        if b.dtype == np.int8:
            np.testing.assert_array_equal(b, np.asarray(a))
        else:
            _assert_scales(b, a, bits, maxulp=4)


def test_fake_quant_act_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 5, 5, 3)).astype(
        np.float32)
    for bits in (4, 8):
        want = jq.fake_quant_act(jnp.asarray(x), bits)
        got = tq.fake_quant_act(_t(x), bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_requantize_matches_jitted_reference():
    """The reference requantizes inside jit, where XLA turns ``y / s`` for a
    static ``s`` into ``y * fp32(1/s)``; ref.requantize multiplies by the
    same reciprocal, so the codes agree everywhere, ties included."""
    rng = np.random.default_rng(1)
    for s in (0.0123456, 3.3, 0.37):
        y = (rng.standard_normal(20000) * 60 * s).astype(np.float32)
        y[:64] = (np.arange(64) - 32 + 0.5) * np.float32(s)   # near ties
        want = jax.jit(lambda a, _s=s: jref.requantize(a, _s))(y)
        got = ref.requantize(_t(y), s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_round_half_to_even_on_both_sides():
    ties = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(ties)).numpy(),
                                  np.asarray(jnp.round(ties)))
    np.testing.assert_array_equal(torch.round(_t(ties)).numpy(),
                                  [-2, -2, -0, 0, 2, 2])


def test_tiling_matches_reference():
    for dim in (1, 7, 127, 128, 131, 256, 1000):
        assert tiling.pad_to(dim) == jtiling.pad_to(dim)
        assert tiling.batch_slots(dim) == jtiling.batch_slots(dim)
        assert tiling.fit_or_pad(128, dim) == jtiling.fit_or_pad(128, dim)
    assert tiling.SMEM_BUDGET == 227 * 1024
    with pytest.raises(ValueError):
        tiling.fit_block(128, 131)


def test_cpu_tensors_take_the_plain_versions():
    reset_counts()
    x = torch.zeros((4, 8), dtype=torch.int8)
    ops.quant_matmul(x, torch.zeros((8, 3), dtype=torch.int8),
                     torch.ones(4), torch.ones(3))
    ops.fake_quant(torch.ones((8, 3)))
    ops.depthwise_conv_static(torch.zeros((1, 4, 4, 2), dtype=torch.int8),
                              torch.zeros((3, 3, 1, 2), dtype=torch.int8),
                              torch.ones(2), sx=1.0)
    x, u, v, su, sv, bu, bv = map(_t, _lr_operands(0, 1))
    ops.lowrank_conv_nhwc(x, u, v, su, sv, bu, bv, sx=0.05, h_scale=0.9)
    c = counts()
    assert c['quant_matmul'] == {'launches': 0, 'plain_calls': 1}
    for k in ('fake_quant_fused', 'depthwise_conv', 'lowrank_conv'):
        assert c[k] == {'launches': 0, 'plain_calls': 1}, k
    reset_counts()
    assert all(v == {'launches': 0, 'plain_calls': 0}
               for v in counts().values())


def test_wide_stripe_routes_to_the_two_pass_wrapper():
    """A (K, 256) stripe over the fused budget routes to the two-pass pair
    (ported since; it used to raise), as in the reference."""
    reset_counts()
    w = torch.ones((8192, 256))
    np.testing.assert_array_equal(ops.fake_quant(w).numpy(), w.numpy())
    assert counts()['fake_quant'] == {'launches': 0, 'plain_calls': 1}
    assert counts()['fake_quant_fused'] == {'launches': 0, 'plain_calls': 0}


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, 'which', lambda _: None)
    monkeypatch.setattr(_build.os.path, 'exists', lambda _: False)
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.nvcc()


def test_build_key_covers_shared_headers(monkeypatch, tmp_path):
    """Each library's cache key hashes every file under csrc/, so an edit
    to a shared header gives every kernel a new library path."""
    import shutil
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, 'CSRC', csrc)
    names = ('quant_matmul', 'lowrank_conv', 'depthwise_conv')
    before = {n: _build._lib_path(n) for n in names}
    assert len(set(before.values())) == len(names)
    assert before == {n: _build._lib_path(n) for n in names}
    header = csrc / 'int8_tiles.cuh'
    header.write_text(header.read_text() + '\n// edited\n')
    after = {n: _build._lib_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)


# ---------------------------------------------------------------- the wgmma
# route's launch plan and the K-major weight layout

PLAN_MS = (1, 2, 31, 32, 128, 129, 512, 2048, 8192, 32768)
PLAN_RANKS = (2, 3, 8, 16, 24, 37, 64, 100, 128, 160, 255, 256)


def _matmul_shapes(name):
    """(K, N) of every conv and dense layer of a config that goes through
    quant_matmul at full width (depthwise convs excluded), the exit heads'
    included; for resnet34-cifar also the chained halves of its factored
    convs at a sweep of ranks."""
    from repro_torch.configs.cnn import MOBILENETV2_CIFAR, RESNET34_CIFAR
    from repro_torch.models.cnn import init_cnn
    from repro_torch.tree import tree_leaves
    cfg = {'resnet34-cifar': RESNET34_CIFAR,
           'mobilenetv2-cifar': MOBILENETV2_CIFAR}[name]
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    shapes = {(w, cfg.num_classes) for w in cfg.stage_widths}
    for w in tree_leaves(params):
        if w.dim() == 4 and w.shape[2] > 1 or w.dim() == 4 and \
                w.shape[:2] == (1, 1):
            shapes.add((w.shape[0] * w.shape[1] * w.shape[2], w.shape[3]))
        elif w.dim() == 2:
            shapes.add(tuple(w.shape))
    if name == 'resnet34-cifar':
        for k, n in list(shapes):
            for r in PLAN_RANKS:
                if r < min(k, n):
                    shapes |= {(k, r), (r, n)}
    return sorted(shapes)


@pytest.mark.parametrize('config', ['resnet34-cifar', 'mobilenetv2-cifar'])
def test_qmm_plan_covers_every_output_and_k_tile_once(config):
    """For every main-path (K, N) at M from 1 to 32768: the grid's 128-row
    and BN-column tiles cover the output exactly once, the C ranks of a
    cluster split the K tiles evenly and cover each once, each rank sums
    and writes a whole share of the tile's rows, a split grid stays within
    one block an SM, and two blocks' shared memory fits an H100 SM."""
    from repro_torch.kernels.quant_matmul import (QMM_BK, qmm_k_tiles,
                                                  qmm_plan, qmm_smem_bytes)
    shapes = _matmul_shapes(config)
    assert (4608, 512) in shapes or config != 'resnet34-cifar'
    for K, N in shapes:
        nk = -(-K // QMM_BK)
        for M in PLAN_MS:
            bm, bn, stages, c, smem = qmm_plan(M, N, K)
            tm, tn = -(-M // bm), -(-N // bn)
            assert bm == 128 and bn == (32 if N <= 32 else 64)
            assert (tm - 1) * bm < M <= tm * bm
            assert (tn - 1) * bn < N <= tn * bn
            assert c in (1, 2, 4) and bm % c == 0
            ks = [qmm_k_tiles(K, c, r) for r in range(c)]
            assert [t for r in ks for t in r] == list(range(nk))
            assert min(len(r) for r in ks) >= 1
            assert max(len(r) for r in ks) - min(len(r) for r in ks) <= 1
            assert c == 1 or tm * tn * c <= 132
            assert 1 <= stages <= max(len(r) for r in ks)
            assert smem == qmm_smem_bytes(bn, stages) <= tiling.SMEM_BUDGET
            assert 2 * (smem + 1024) <= 228 * 1024      # two blocks an SM


def test_qmm_sweep_script_finds_every_stamp_marker():
    """scripts/qmm_plan_sweep.py times the wgmma kernel's phases on a card
    by inserting stamps after marker lines of the CUDA source, in a copy
    that also takes the plans beyond qmm_plan's (BN 128, clusters of 8);
    every marker still occurs exactly once, every phase boundary is
    stamped and the wider plans and the occupancy entry point are in (the
    m64n128k32 step BN 128 runs is in the shared wgmma_tma.cuh)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), '..', 'scripts',
                        'qmm_plan_sweep.py')
    spec = importlib.util.spec_from_file_location('qmm_plan_sweep', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    src = module.instrumented_source()
    for text, stamps in module.MARKS:
        assert src.count(text + ''.join(f'  STAMP({i});\n'
                                        for i in stamps)) == 1
    assert all(f'STAMP({i});' in src for i in range(6))
    for text in ('launch_wgmma<BN_, 8>', 'launch_wgmma_bn<128>',
                 'WG_MAX_STAGES = 8;', 'quant_matmul_wgmma_max_clusters',
                 '#include "wgmma_tma.cuh"'):
        assert text in src
    # the m64n128k32 step BN 128 needs comes from the shared header
    assert 'struct Wgmma<128>' in (_build.CSRC / 'wgmma_tma.cuh').read_text()


def test_qmm_plan_splits_k_where_the_output_is_small():
    """resnet34-cifar at 32 slots, in 128 x 64 tiles: stages 0 and 1 fill
    the card with 256 and 128 tiles and no split; stages 2 and 3 (64 and 32
    tiles) split K over clusters of 2 and 4, 128 blocks each; the M tail
    of stage 3 (24 tiles) over 4; a head's one tile over 4."""
    from repro_torch.kernels.quant_matmul import qmm_plan
    assert qmm_plan(32768, 64, 576)[1:4] == (64, 4, 1)
    assert qmm_plan(8192, 128, 1152)[1:4] == (64, 4, 1)
    assert qmm_plan(2048, 256, 2304)[1:4] == (64, 4, 2)
    assert qmm_plan(512, 512, 4608)[1:4] == (64, 4, 4)
    assert qmm_plan(300, 512, 4608)[3] == 4
    assert qmm_plan(32, 10, 512)[1:4] == (32, 1, 4)


def test_split_k_partials_sum_to_the_product():
    """The kernel's split of K: the int32 partial products over each
    rank's K tiles, summed, equal the whole product exactly."""
    from repro_torch.kernels.quant_matmul import QMM_BK, qmm_k_tiles
    rng = np.random.default_rng(3)
    x, w = _t(_i8(rng, 40, 600)), _t(_i8(rng, 600, 24))
    want = ref.int_matmul(x, w)
    for c in (1, 2, 4, 8):
        got = sum(ref.int_matmul(x[:, r.start * QMM_BK:r.stop * QMM_BK],
                                 w[r.start * QMM_BK:r.stop * QMM_BK])
                  for r in (qmm_k_tiles(600, c, q) for q in range(c)))
        assert torch.equal(got, want)


def test_qmm_route_and_operand_layouts():
    """The route follows K % 16 and alignment alone; the operand check
    takes a row-major or a K-major w and nothing else; the plain version
    gives the same bits on the K-major copy of w."""
    from repro_torch.kernels.quant_matmul import (_check_operands, k_major,
                                                  qmm_route,
                                                  quant_matmul_plain)
    rng = np.random.default_rng(4)
    for K, route in ((576, 'wgmma'), (27, 'mma_sync'), (24, 'mma_sync'),
                     (16, 'wgmma')):
        x, w = _t(_i8(rng, 33, K)), _t(_i8(rng, K, 10))
        assert qmm_route(x, w) == route
        wk = w.t().contiguous().t()
        assert k_major(wk) and not k_major(w) and wk.stride() == (1, K)
        sx, sw = torch.rand(33), torch.rand(10)
        _check_operands(x, w, sx, sw, None)
        _check_operands(x, wk, sx, sw, None)
        for kw in (dict(), dict(relu=True, out_scale=0.37)):
            want = quant_matmul_plain(x, w, sx, sw, **kw)
            assert torch.equal(quant_matmul_plain(x, wk, sx, sw, **kw), want)
        with pytest.raises(ValueError, match='K-major'):
            _check_operands(x, torch.cat([w, w], 1)[:, ::2], sx, sw, None)
    buf = torch.zeros(33 * 64 + 1, dtype=torch.int8)
    x_off = buf[1:].view(33, 64)                 # not on 16 bytes
    assert qmm_route(x_off, torch.zeros((64, 8), dtype=torch.int8)) == \
        'mma_sync'


@pytest.mark.parametrize('factorize', [False, True])
def test_export_lays_quant_matmul_weights_out_k_major(factorize):
    """export_cnn stores every weight its plan routes to quant_matmul or
    lowrank_conv K-major with the same values, so quant_conv's and
    lowrank_conv_nhwc's reshapes are views with strides (1, K); depthwise
    leaves keep their row-major layout."""
    from repro_torch.configs.cnn import MOBILENET_SMALL_CIFAR, RESNET8_CIFAR
    from repro_torch.core.export import _resolve_layer_params, export_cnn
    from repro_torch.core.family import CNNFamily
    from repro_torch.core.quantization import quantize_params_for_serving
    from repro_torch.data import SyntheticImages
    base = RESNET8_CIFAR if factorize else MOBILENET_SMALL_CIFAR
    fam = CNNFamily(SyntheticImages(), device='cpu')
    params = fam.init(torch.Generator().manual_seed(0), base)
    cfg = base
    if factorize:
        params, cfg, _ = fam.factorize(params, cfg, energy=0.6, min_rank=2)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                cfg, fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    x = fam.eval_batches(1, 4)[0][0]
    model = export_cnn(params, cfg, device='cpu', calibrate=x,
                       select_kernels='fused' if factorize else 'model')
    fresh = quantize_params_for_serving(params, bits=8)
    kinds = set()
    for name, e in model.plan.layers.items():
        p = _resolve_layer_params(model.params, name)
        q = _resolve_layer_params(fresh, name)
        pairs = [(p['u'], q['u']), (p['v'], q['v'])] if e['factored'] \
            else [(p, q)]
        for leaf, want in pairs:
            w = leaf['w_q']
            assert torch.equal(w, want['w_q'])
            n = w.shape[-1]
            w2 = w.reshape(-1, n)
            routed = not e.get('depthwise')
            assert (w2.stride() == (1, w2.shape[0])) == routed or n == 1
            assert w.is_contiguous() != routed or n == 1
            kinds.add('fused' if e.get('fused') else
                      'depthwise' if e.get('depthwise') else 'quant_matmul')
    assert kinds == ({'quant_matmul', 'fused'} if factorize
                     else {'quant_matmul', 'depthwise'})


# ---------------------------------------------------------------- the fused
# low-rank kernel's wgmma launch plan

# factored resnet34-cifar's fused shapes at 32 slots (ranks at energy 0.6)
LR_MAIN_SHAPES = [(32768, 576, 30, 64), (8192, 576, 52, 128),
                  (8192, 1152, 59, 128), (8192, 64, 20, 128),
                  (2048, 1152, 103, 256), (2048, 2304, 118, 256),
                  (2048, 128, 41, 256), (512, 256, 82, 512)]


@pytest.mark.parametrize('m', PLAN_MS)
def test_lr_plan_covers_every_row_k1_tile_and_column_once(m):
    """At M from 1 to 32768 and every (K1, R, N) of the fused envelope the
    CNN configs make (and ragged ones): the grid's 128-row tiles cover M
    once; the C ranks of a cluster cover every 128-byte K1 tile once,
    every row of the h tile once and every VN-wide COUT tile once (each
    rank at least 64 columns where C > 1); the rank tile holds R; two
    blocks fit an SM."""
    from repro_torch.kernels.lowrank_conv import (LR_BK, LR_RPS, LR_VNS,
                                                  lr_h_rows, lr_k_tiles,
                                                  lr_n_tiles, lr_smem_bytes)
    shapes = LR_MAIN_SHAPES + [(m, k1, r, n) for k1 in (16, 72, 576, 2304)
                               for r in (2, 31, 64, 97, 128)
                               for n in (10, 64, 100, 512)]
    for _, k1, r, n in shapes:
        bm, rp, vn, stages, c, smem = lr_plan(m, k1, r, n)
        assert bm == 128 and rp in LR_RPS and r <= rp < r + 32
        assert vn in LR_VNS and c in (1, 2, 4, 8)
        rows = np.zeros(-(-m // bm) * bm, int)
        for t in range(-(-m // bm)):
            rows[t * bm:(t + 1) * bm] += 1
        assert (rows[:m] == 1).all()
        nk = -(-k1 // LR_BK)
        ks = [lr_k_tiles(k1, c, q) for q in range(c)]
        assert sorted(t for rg in ks for t in rg) == list(range(nk))
        hs = [lr_h_rows(c, q) for q in range(c)]
        assert sorted(t for rg in hs for t in rg) == list(range(bm))
        assert all(len(rg) == bm // c for rg in hs)
        nt = -(-n // vn)
        ns = [lr_n_tiles(n, vn, c, q) for q in range(c)]
        assert sorted(t for rg in ns for t in rg) == list(range(nt))
        assert c == 1 or min(len(rg) for rg in ns) * vn >= 64
        assert 1 <= stages <= 4 and (c == 1 or stages <= max(
            1, max(len(rg) for rg in ks)))
        assert smem == lr_smem_bytes(rp, vn, stages, c) <= \
            tiling.SMEM_BUDGET
        assert 2 * (smem + 1024) <= 228 * 1024       # two blocks an SM


@pytest.mark.parametrize('shape', LR_MAIN_SHAPES)
def test_lr_plan_fits_the_card_in_one_wave(shape):
    """At each fused shape of factored resnet34-cifar at 32 slots: the rank
    tile is the rank rounded up to 32 (rank 30 pays for 32 columns, not
    128); a split grid holds at most 132 blocks, two to an SM, so it runs
    in one wave; the layout fits the shared-memory budget; the clusters
    and v tiles are the ones measured fastest (scripts/lr_plan_sweep.py)."""
    from repro_torch.kernels.lowrank_conv import lr_smem_bytes
    m, k1, r, n = shape
    bm, rp, vn, stages, c, smem = lr_plan(m, k1, r, n)
    assert rp == -(-r // 32) * 32
    blocks = c * -(-m // bm)
    assert c == 1 or blocks <= 132
    assert smem == lr_smem_bytes(rp, vn, stages, c) <= tiling.SMEM_BUDGET
    assert 2 * (smem + 1024) <= 228 * 1024
    assert (c, vn) == {32768: (1, 64), 8192: (2, 64), 2048: (4, 64),
                       512: (8, 64)}[m]


def test_lr_split_k_partial_h_sums_to_the_product():
    """The kernel's split of K1: the int32 partial h tiles over each
    rank's K1 tiles, summed, equal patches @ u exactly, and the fused
    result from that sum equals the plain version."""
    from repro_torch.kernels.lowrank_conv import (LR_BK, lowrank_conv_plain,
                                                  lr_k_tiles)
    rng = np.random.default_rng(5)
    x, u, v = _t(_i8(rng, 40, 1200)), _t(_i8(rng, 1200, 30)), \
        _t(_i8(rng, 30, 24))
    su, sv = torch.rand(30) * 1e-3, torch.rand(24) * 1e-2
    bu, bv = torch.randn(30), torch.randn(24)
    want = ref.int_matmul(x, u)
    for c in (1, 2, 4, 8, 16):
        parts = [ref.int_matmul(x[:, rg.start * LR_BK:rg.stop * LR_BK],
                                u[rg.start * LR_BK:rg.stop * LR_BK])
                 for rg in (lr_k_tiles(1200, c, q) for q in range(c))]
        assert torch.equal(sum(parts), want)
    scale = torch.full((40, 1), 0.05) * su[None, :]
    h = ref.epilogue(want, scale, bu, False, 0.9, 127.0)
    y = ref.epilogue(ref.int_matmul(h, v), torch.full((40, 1), 0.9) *
                     sv[None, :], bv, True, 0.37, 127.0)
    assert torch.equal(y, lowrank_conv_plain(x, u, v, su, sv, bu, bv, sx=0.05,
                                             h_scale=0.9, relu=True,
                                             out_scale=0.37))


def test_lr_route_and_operand_layouts():
    """The route follows K1 % 16 and alignment alone; the operand check
    takes row-major or K-major u and v and nothing else; the plain version
    gives the same bits on K-major copies."""
    from repro_torch.kernels.lowrank_conv import (_check_operands,
                                                  lowrank_conv_plain,
                                                  lr_route)
    from repro_torch.kernels.quant_matmul import k_major
    rng = np.random.default_rng(6)
    for k1, route in ((576, 'wgmma'), (27, 'mma_sync'), (72, 'mma_sync'),
                      (16, 'wgmma')):
        x, u, v = _t(_i8(rng, 33, k1)), _t(_i8(rng, k1, 30)), \
            _t(_i8(rng, 30, 10))
        uk, vk = u.t().contiguous().t(), v.t().contiguous().t()
        assert k_major(uk) and k_major(vk) and uk.stride() == (1, k1)
        assert lr_route(x, uk, vk) == route
        su, sv, bu, bv = torch.rand(30), torch.rand(10), torch.randn(30), \
            torch.randn(10)
        for a, b in ((u, v), (uk, vk), (uk, v)):
            _check_operands(x, a, b, su, sv, bu, bv)
        kw = dict(sx=0.05, h_scale=0.9, relu=True, out_scale=0.37)
        assert torch.equal(lowrank_conv_plain(x, uk, vk, su, sv, bu, bv, **kw),
                           lowrank_conv_plain(x, u, v, su, sv, bu, bv, **kw))
        with pytest.raises(ValueError, match='K-major'):
            _check_operands(x, torch.cat([u, u], 1)[:, ::2], v, su, sv, bu,
                            bv)
    buf = torch.zeros(33 * 64 + 1, dtype=torch.int8)
    x_off = buf[1:].view(33, 64)                 # not on 16 bytes
    w = torch.zeros((64, 8), dtype=torch.int8).t().contiguous().t()
    assert lr_route(x_off, w, torch.zeros((8, 4), dtype=torch.int8)) == \
        'mma_sync'


def test_lowrank_nhwc_reshapes_k_major_factors_to_views():
    """K-major 4-D factors as the export stores them reshape, in
    ops.lowrank_conv_nhwc, to (K1, R) and (R, N) views with strides
    (1, K1) and (1, R): no copy before the kernel."""
    from repro_torch.core.export import k_major
    u = k_major(torch.zeros((3, 3, 16, 30), dtype=torch.int8))
    v = k_major(torch.zeros((1, 1, 30, 64), dtype=torch.int8))
    u2, v2 = u.reshape(144, 30), v.reshape(30, 64)
    assert u2.stride() == (1, 144) and v2.stride() == (1, 30)
    assert u2.data_ptr() == u.data_ptr() and v2.data_ptr() == v.data_ptr()
