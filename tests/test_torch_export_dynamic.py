"""The port's dynamic-scale serving path (``kernels/ops.py``'s
``quantize_act``, ``quant_dense``, ``quantize_dense_int8``,
``quant_conv_nhwc``; ``export_cnn(calibrate=None)``; ``Pipeline.export`` of
a CNN chain) against ``jax.jit`` of the JAX package's, on the same numpy
inputs.  On the CPU the port's wrappers run the kernels' plain versions.

Tolerances, each with its reason:

* ``quantize_act``: codes and scales bit for bit.  The reference jits it;
  XLA folds the scale's ``/ qmax`` into ``* fp32(1/qmax)`` and keeps
  ``x / s`` a true division by the traced scale (its compiled HLO), and
  the port computes both so;
* ``quant_dense``, ``quantize_dense_int8``, ``quant_conv_nhwc`` (dense and
  depthwise): within rtol 1e-6 of the reference's Pallas path in
  interpret mode (the same int32 accumulator; XLA may contract the
  epilogue's ``acc * scale + bias`` into an FMA inside jit, torch does
  not), and within 1e-5 x max|y| of its jnp path (which multiplies
  ``(acc * sx) * sw`` in another order, or convolves dequantized fp32);
* the exported models: ``fn`` and ``fn_exits`` within 1e-3 x max|logit|
  of the reference's Pallas-path export (its GroupNorm and mean pool sum
  fp32 in other orders; a code at a rounding tie may flip) and within
  4e-2 x max|logit| of its jnp-path export, the reference's own
  Pallas-against-jnp tolerance (ROADMAP C);
* the stage segments chained against ``fn_exits``: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn as jcnn
from repro.core import family as jfamily
from repro.core import passes as jpasses
from repro.core import quantization as jq
from repro.core.export import export_chain as j_export_chain
from repro.core.export import export_cnn as j_export_cnn
from repro.data import SyntheticImages as JImages
from repro.kernels import ops as jops
from repro_torch.configs import cnn as tcnn
from repro_torch.core import chain as tchain
from repro_torch.core import family as tfamily
from repro_torch.core import passes as tpasses
from repro_torch.core import quantization as tq
from repro_torch.core.export import export_cnn
from repro_torch.data import SyntheticImages
from repro_torch.interop import from_jax_params
from repro_torch.kernels import counts, ops, reset_counts
from repro_torch.kernels.quant_matmul import k_major

torch.set_num_threads(1)

KINDS = ('resnet8-cifar', 'vgg8-cifar', 'mobilenet-small-cifar',
         'resnet8-factored')


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize('a_bits', [8, 4, 2])
@pytest.mark.parametrize('per_row', [False, True])
def test_quantize_act_matches_jitted_reference(a_bits, per_row):
    rng = np.random.default_rng(a_bits * 10 + per_row)
    for scale in (1e-3, 1.0, 37.0):
        x = (rng.standard_normal((33, 70)) * scale).astype(np.float32)
        x[3] = 0.0                       # a row at the 1e-8 floor
        jx, js = jax.jit(lambda v: jops.quantize_act(
            v, a_bits=a_bits, per_row=per_row))(x)
        tx, ts = ops.quantize_act(_t(x), a_bits=a_bits, per_row=per_row)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert ts.dtype == torch.float32 and ts.shape == np.shape(js)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('per_row', [False, True])
@pytest.mark.parametrize('mkn', [(37, 27, 13), (16, 64, 128)])
def test_quant_dense_matches_reference(per_row, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n + per_row)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w_q, sw = jops.prequantize_weight(jnp.asarray(w))
    got = ops.quant_dense(_t(x), _t(w_q), _t(sw), per_row=per_row)
    for use_pallas, rtol in ((True, 1e-6), (False, 1e-5)):
        want = jax.jit(lambda a, b, c: jops.quant_dense(
            a, b, c, per_row=per_row, use_pallas=use_pallas))(x, w_q, sw)
        _close(got, want, rtol)
    got = ops.quantize_dense_int8(_t(x), _t(w), per_row=per_row)
    want = jax.jit(lambda a, b: jops.quantize_dense_int8(
        a, b, per_row=per_row, use_pallas=True))(x, w)
    _close(got, want, 1e-6)


@pytest.mark.parametrize('case', [
    dict(shape=(2, 9, 9, 5), k=3, cout=7, stride=1, groups=1),
    dict(shape=(2, 8, 8, 16), k=3, cout=24, stride=2, groups=1, relu=True),
    dict(shape=(2, 8, 8, 16), k=1, cout=8, stride=1, groups=1),
    dict(shape=(2, 8, 8, 16), k=3, cout=16, stride=1, groups=16),
    dict(shape=(2, 9, 9, 8), k=3, cout=16, stride=2, groups=8, relu=True),
])
@pytest.mark.parametrize('a_bits', [8, 4])
def test_quant_conv_nhwc_matches_reference(case, a_bits):
    rng = np.random.default_rng(sum(case['shape']) + case['cout'] + a_bits)
    x = rng.standard_normal(case['shape']).astype(np.float32)
    cin = case['shape'][-1] // case['groups']
    w = rng.standard_normal((case['k'], case['k'], cin, case['cout'])
                            ).astype(np.float32)
    b = rng.standard_normal((case['cout'],)).astype(np.float32)
    w_q, sw = jops.prequantize_weight(jnp.asarray(w))
    kw = dict(stride=case['stride'], groups=case['groups'],
              relu=case.get('relu', False), a_bits=a_bits)
    reset_counts()
    got = ops.quant_conv_nhwc(_t(x), _t(w_q), _t(sw), _t(b), **kw)
    c = counts()
    kernel = 'depthwise_conv' if case['groups'] > 1 else 'quant_matmul'
    assert c[kernel] == {'launches': 0, 'plain_calls': 1}
    for use_pallas, rtol in ((True, 1e-6), (False, 1e-5)):
        want = jax.jit(lambda a, q, s, bb: jops.quant_conv_nhwc(
            a, q, s, bb, use_pallas=use_pallas, **kw))(x, w_q, sw, b)
        _close(got, want, rtol)


def test_grouped_conv_with_depth_above_one_raises():
    """A grouped conv with per-group depth > 1 no longer raises: it is the
    reference's declared fp32 fallback, ``ref.quant_conv_ref`` on the
    dynamic codes, with no kernel call (``tests/test_torch_grouped_conv.py``
    holds it against the reference)."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 8)).astype(np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 2, 8)
                                        ).astype(np.int8))
    sw = torch.full((8,), 0.01)
    reset_counts()
    got = ops.quant_conv_nhwc(x, w_q, sw, groups=4)
    assert all(c == {'launches': 0, 'plain_calls': 0}
               for c in counts().values())
    xq, sx = ops.quantize_act(x)
    assert torch.equal(got, ref.quant_conv_ref(xq, w_q, sx, sw, groups=4))


def test_quantized_params_bits_matches_reference():
    p = jfamily.CNNFamily(JImages()).init(jax.random.key(0),
                                          jcnn.RESNET8_CIFAR)
    for bits in (8, 4, 1):
        assert tq.quantized_params_bits(from_jax_params(p), bits) == \
            jq.quantized_params_bits(p, bits)


# ------------------------------------------------------------- the export


_MODELS = {}


def _model(kind):
    """(reference params, reference cfg, port cfg) of ``kind`` with exit
    heads at the default stages, W8A8; ``resnet8-factored`` is resnet8
    after the reference's ``factorize(energy=0.6, min_rank=2)``."""
    if kind not in _MODELS:
        name = 'resnet8-cifar' if kind == 'resnet8-factored' else kind
        cfg = jcnn.CNN_REGISTRY[name]
        fam = jfamily.CNNFamily(JImages())
        p = fam.init(jax.random.key(0), cfg)
        if kind == 'resnet8-factored':
            p, cfg, _ = fam.factorize(p, cfg, energy=0.6, min_rank=2)
        p, cfg = fam.add_exits(jax.random.key(1), p, cfg,
                               fam.default_exit_points(cfg))
        cfg = cfg.replace(w_bits=8, a_bits=8)
        _MODELS[kind] = (jax.tree.map(np.asarray, p), cfg,
                         tcnn.CNNConfig(**dataclasses.asdict(cfg)))
    return _MODELS[kind]


def _images(seed, n=4):
    return np.random.default_rng(seed).standard_normal(
        (n, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize('kind', KINDS)
def test_dynamic_export_matches_reference(kind):
    """``fn`` and ``fn_exits`` of the port's dynamic export against the
    reference's, on its Pallas path (interpret mode) and its jnp path;
    the stage segments chained equal ``fn_exits`` bit for bit."""
    jp, jc, tc = _model(kind)
    x = _images(7)
    model = export_cnn(from_jax_params(jp), tc, device='cpu')
    assert model.plan is None and model.backend == 'plain'
    assert model.n_stages == len(tc.exit_stages) + 1
    reset_counts()
    lg, exits = model.fn_exits(model.params, _t(x))
    c = counts()
    assert all(v['launches'] == 0 for v in c.values())
    assert c['quant_matmul']['plain_calls'] > 0
    assert (c['depthwise_conv']['plain_calls'] > 0) == \
        (kind == 'mobilenet-small-cifar')
    assert c['lowrank_conv']['plain_calls'] == 0
    for use_pallas, rtol in ((True, 1e-3), (False, 4e-2)):
        ref = j_export_cnn(jp, jc, use_pallas=use_pallas)
        jl, je = ref.fn_exits(ref.params, x)
        _close(lg, jl, rtol)
        assert sorted(exits) == sorted(je)
        for s in je:
            _close(exits[s], je[s], rtol)
    _close(model.fn(model.params, _t(x)), jl, 4e-2)
    assert torch.equal(model.fn(model.params, _t(x)), lg)
    h, seg_exits = _t(x), {}
    for i in range(model.n_stages - 1):
        e, h = model.run_stage(i, h)
        assert h.dtype == torch.float32         # the fp32 carry
        seg_exits.update(e)
    assert torch.equal(model.run_stage(model.n_stages - 1, h), lg)
    assert all(torch.equal(seg_exits[s], exits[s]) for s in exits)
    assert torch.equal(model.serve_stages(_t(x))[0], lg)


@pytest.mark.parametrize('kind', ['mobilenet-small-cifar',
                                  'resnet8-factored'])
def test_dynamic_export_stores_matmul_weights_k_major(kind):
    """Every weight the dynamic path sends to ``quant_matmul`` is K-major
    (no relayout on the card); the depthwise weights stay row-major."""
    jp, _, tc = _model(kind)
    model = export_cnn(from_jax_params(jp), tc, device='cpu')
    seen = []

    def walk(node, key=''):
        if isinstance(node, dict):
            if 'w_q' in node:
                w = node['w_q']
                seen.append(key)
                if key == 'dw':
                    assert w.is_contiguous()
                else:
                    assert k_major(w.reshape(-1, w.shape[-1]))
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)
    walk(model.params)
    assert ('dw' in seen) == (kind == 'mobilenet-small-cifar')
    assert ('u' in seen) == (kind == 'resnet8-factored')


def test_pipeline_export_of_a_cnn_chain_matches_reference():
    """``Pipeline.export`` of a CNN chain state (exit heads, an operating
    point) against the reference's ``export_chain`` of the same state."""
    jp, jc, tc = _model('resnet8-cifar')
    tst = tpasses.ChainState(
        family=tfamily.CNNFamily(SyntheticImages(), device='cpu'), cfg=tc,
        params=from_jax_params(jp), key=0, exit_threshold=0.3)
    jst = jpasses.ChainState(family=jfamily.CNNFamily(JImages()), cfg=jc,
                             params=jax.tree.map(jnp.asarray, jp),
                             key=jax.random.key(0), exit_threshold=0.3)
    model = tchain.Pipeline.from_sequence('E').export(tst, device='cpu')
    ref = j_export_chain(jst, use_pallas=True)
    assert model.plan is None and model.exit_threshold == 0.3 == \
        ref.exit_threshold
    x = _images(9)
    _close(model.serve(_t(x)), ref.serve(x), 1e-3)
    pred, stage = model.serve_early_exit(_t(x))
    jpred, jstage = ref.serve_early_exit(x)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(stage.numpy(), np.asarray(jstage))
