"""The grouped-conv fp32 fallback at the port's two CNN tiers against the
JAX package's, on the same numpy inputs (CPU).

A grouped conv whose groups have an input depth above 1 (no configuration
has one) is the reference's declared fallback: ``ref.quant_conv_ref`` on
the dequantized operands, int8 in and fp32 out.

* The dynamic tier: ``kernels/ops.quant_conv_nhwc`` at groups 2 and 4
  (depths 8 and 4), with bias and ReLU, strides 1 and 2, against
  ``jax.jit`` of the reference's ``quant_conv_nhwc`` (which runs
  ``lax.conv`` there on its Pallas and jnp paths alike): the same dynamic
  codes, the outputs within 1e-6 x max|y| (two fp32 convs summing in their
  own orders).  No kernel launches and no plain version runs.
* The resident tier: the layer plan of a three-layer model (stem conv,
  the grouped conv, a head) compiled by each package's
  ``_compile_layer_plan`` (its ``cnn_forward`` swapped for that model's
  forward in both); the grouped layer's entry marked ``fallback`` with 0
  launches and the summary's ``n_fallback`` and ``fallback_mac_fraction``
  equal to the reference's; the port's resident ``conv_fn`` on that entry
  against ``jax.jit`` of the reference's (``core/export.py``'s
  ``_resident_layers``) on the same int8 codes, within 1e-6 x max|y|.

* A served model: mobilenet-small-cifar with exit heads, its first
  depthwise weight repeated to per-group depth 2, exported by each
  package's ``export_cnn`` at both tiers (with ``calibrate=`` and
  without; the port's resident export with ``verify='strict'``) and
  served.  No configuration's forward passes such a conv, so in both
  packages ``cnn_forward`` reads each conv's groups off its weight (the
  input's depth over the weight's), which changes nothing for any other
  conv.  The plan entries, ``n_fallback`` and ``fallback_mac_fraction``
  as the reference's; the calibrated scales within rtol 1e-5 and the
  logits and exit logits of the reference's Pallas path (interpret mode)
  within 4e-2 x max|logit| on the resident tier and 1e-3 on the dynamic
  one (the whole-model tolerances of ``tests/test_torch_serving.py`` and
  ``tests/test_torch_export_dynamic.py``: fp32 forwards whose codes can
  round apart at a tie); ``serve``, the stage segments and the
  scheduler on the port's own ``fn_exits``, bit for bit; the plain calls
  as the plan counts them.

About 10 s on one core.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn as jcnn
from repro.core import export as jexport
from repro.core.family import CNNFamily as JFamily
from repro.data import SyntheticImages as JImages
from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.models import cnn as jcnn_lib
from repro_torch.configs import cnn as tcnn
from repro_torch.core import export as texport
from repro_torch.core import quantization as tq
from repro_torch.interop import from_jax_params
from repro_torch.kernels import counts, ops, reset_counts
from repro_torch.models import cnn as tcnn_lib
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 exit_decisions)

TOL = 1e-6              # x max|y|: two fp32 convs, their own sum orders
C, HW, B = 16, 8, 2     # channels, spatial size, batch


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize('groups', [2, 4])
@pytest.mark.parametrize('stride,relu', [(1, False), (2, True)])
def test_quant_conv_nhwc_fallback_matches_reference(groups, stride, relu):
    rng = np.random.default_rng(groups * 10 + stride)
    x = rng.standard_normal((B, HW, HW, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, C // groups, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    w_q, sw = jops.prequantize_weight(jnp.asarray(w))
    kw = dict(stride=stride, groups=groups, relu=relu)
    reset_counts()
    got = ops.quant_conv_nhwc(_t(x), _t(w_q), _t(sw), _t(b), **kw)
    assert all(c == {'launches': 0, 'plain_calls': 0}
               for c in counts().values())
    for use_pallas in (True, False):
        want = jax.jit(lambda a, q, s, bb: jops.quant_conv_nhwc(
            a, q, s, bb, use_pallas=use_pallas, **kw))(x, w_q, sw, b)
        _close(got.numpy(), want)


# ------------------------------------------------------------ the plan


def _forward(cnn, groups):
    """A cnn_forward of a stem conv, the grouped conv and a head, with the
    layer hooks ``_compile_layer_plan`` and the resident tier inject."""
    def forward(params, cfg, x, *, collect_exits=False, conv_fn=None,
                fc_fn=None, glue_fn=None, pool_fn=None, start_stage=0,
                stop_stage=None):
        quant = (cfg.w_bits, cfg.a_bits)
        h = glue_fn(params['stem_norm'], conv_fn(
            params['stem'], x, quant=quant, name='stem'), act='relu',
            name='stem.norm')
        h = glue_fn(params['gnorm'], conv_fn(
            params['grouped'], h, quant=quant, groups=groups,
            name='grouped'), act='relu', name='grouped.norm')
        logits = fc_fn(params['head'], (pool_fn or cnn.global_pool)(h),
                       quant=quant, name='head')
        return (logits, {}) if collect_exits else logits
    return forward


def _params(rng, groups):
    def norm():
        return {'scale': rng.uniform(0.5, 1.5, (C,)).astype(np.float32),
                'bias': rng.standard_normal((C,)).astype(np.float32)}

    def conv(cin):
        return {'w': (rng.standard_normal((3, 3, cin, C)) * 0.2
                      ).astype(np.float32),
                'b': rng.standard_normal((C,)).astype(np.float32) * 0.1}
    return {'stem': conv(3), 'stem_norm': norm(),
            'grouped': conv(C // groups), 'gnorm': norm(),
            'head': {'w': rng.standard_normal((C, 10)).astype(np.float32),
                     'b': np.zeros((10,), np.float32)}}


@pytest.fixture(scope='module', params=[2, 4], ids=['groups2', 'groups4'])
def plans(request):
    """Both packages' plans and resident conv_fns for the same params."""
    groups = request.param
    rng = np.random.default_rng(groups)
    params = _params(rng, groups)
    x = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jexport.cnn_lib, 'cnn_forward', _forward(jcnn_lib, groups))
        mp.setattr(texport.cnn_lib, 'cnn_forward', _forward(tcnn_lib, groups))
        jparams = jax.tree.map(jnp.asarray, params)
        jplan = jexport._compile_layer_plan(jparams, jcnn.RESNET8_CIFAR,
                                            jnp.asarray(x), 127.0)
        tparams = from_jax_params(params)
        tplan = texport._compile_layer_plan(tparams, tcnn.RESNET8_CIFAR,
                                            _t(x), 127.0)
    finally:
        mp.undo()
    jq_params = jq.quantize_params_for_serving(jparams)
    return {'groups': groups, 'rng': rng, 'j': jplan, 't': tplan,
            'jq': jq_params,
            'tq': tq.quantize_params_for_serving(tparams)}


def test_plan_marks_the_fallback_as_the_reference(plans):
    jplan, tplan = plans['j'], plans['t']
    assert set(tplan.layers) == set(jplan.layers)
    for name, je in jplan.layers.items():
        te = tplan.layers[name]
        for k in ('fallback', 'depthwise', 'launches', 'macs', 'groups'):
            assert te.get(k) == je.get(k), (name, k)
    g = tplan.layers['grouped']
    assert g['fallback'] and g['launches'] == 0 and not g['depthwise']
    js, ts = jplan.summary(), tplan.summary()
    assert ts['n_fallback'] == js['n_fallback'] == 1
    assert ts['kernel_launches'] == js['kernel_launches']
    assert ts['fallback_mac_fraction'] == pytest.approx(
        js['fallback_mac_fraction'], rel=1e-12)
    assert 0 < ts['fallback_mac_fraction'] < 1


def test_resident_fallback_conv_matches_reference(plans):
    """The resident conv_fn on the fallback entry, int8 codes in, fp32
    out, against ``jax.jit`` of the reference's on the same codes."""
    rng, groups = plans['rng'], plans['groups']
    codes = rng.integers(-128, 128, (B, HW, HW, C)).astype(np.int8)
    sx = float(plans['j'].layers['grouped']['sx'])
    jconv = jexport._resident_layers(plans['j'], True)[0]
    tconv = texport._resident_layers(plans['t'])[0]
    jp = plans['jq']['grouped']
    want = jax.jit(lambda q, p: jconv(p, jexport.QAct(q, sx),
                                      groups=groups, name='grouped'))(
        jnp.asarray(codes), jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    reset_counts()
    got = tconv(tp, texport.QAct(_t(codes), sx), groups=groups,
                name='grouped')
    assert all(c == {'launches': 0, 'plain_calls': 0}
               for c in counts().values())
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    # the port's own quantized weights serve the same layer
    got_own = tconv(plans['tq']['grouped'], texport.QAct(_t(codes), sx),
                    groups=groups, name='grouped')
    _close(got_own.numpy(), want)


# ------------------------------------------------------- a served model

GROUPED = 's0b0.dw'     # the layer cut to per-group depth 2
SLOTS = 8


def _grouped_by_weight(forward, default_conv):
    """``forward`` (a package's ``cnn_forward``) with every unfactored
    conv's groups read off its weight: the input's depth over the weight's
    input depth, which is what the forward passes for every conv of a
    configuration."""
    def fwd(params, cfg, x, *, conv_fn=None, **kw):
        inner = conv_fn or default_conv

        def conv(p, h, *, groups=1, **k):
            if 'u' not in p:
                w = p['w'] if 'w' in p else p['w_q']
                groups = h.shape[-1] // w.shape[2]
            return inner(p, h, groups=groups, **k)
        return forward(params, cfg, x, conv_fn=conv, **kw)
    return fwd


@pytest.fixture
def grouped_forward(monkeypatch):
    monkeypatch.setattr(jexport.cnn_lib, 'cnn_forward', _grouped_by_weight(
        jcnn_lib.cnn_forward, jcnn_lib.conv))
    monkeypatch.setattr(texport.cnn_lib, 'cnn_forward', _grouped_by_weight(
        tcnn_lib.cnn_forward, tcnn_lib.conv))


@pytest.fixture(scope='module')
def grouped_model():
    fam = JFamily(JImages())
    cfg = jcnn.MOBILENET_SMALL_CIFAR
    p = fam.init(jax.random.key(0), cfg)
    p, cfg = fam.add_exits(jax.random.key(2), p, cfg,
                           fam.default_exit_points(cfg))
    p = jax.tree.map(np.asarray, p)
    dw = p['stages'][0][0]['dw']
    dw['w'] = np.tile(dw['w'], (1, 1, 2, 1))     # per-group depth 2
    x = np.random.default_rng(0).standard_normal(
        (SLOTS, 16, 16, 3)).astype(np.float32)
    return p, cfg.replace(w_bits=8, a_bits=8), x


def _close_logits(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize('tier', ['resident', 'dynamic'])
def test_grouped_model_exports_and_serves_as_reference(
        grouped_model, grouped_forward, tier):
    p, cfg, x = grouped_model
    resident = tier == 'resident'
    want = jexport.export_cnn(p, cfg, use_pallas=True,
                              calibrate=x if resident else None)
    tol = 4e-2 if resident else 1e-3
    model = texport.export_cnn(
        from_jax_params(p), cfg, device='cpu',
        calibrate=_t(x) if resident else None,
        verify='strict' if resident else None)
    if resident:
        assert model.analysis.ok
        for name, je in want.plan.layers.items():
            te = model.plan.layers[name]
            for k in ('fallback', 'depthwise', 'launches', 'macs', 'groups'):
                assert te.get(k) == je.get(k), (name, k)
            for k in ('sx', 'out_scale'):
                if je[k] is not None:
                    np.testing.assert_allclose(te[k], je[k], rtol=1e-5,
                                               err_msg=name)
        g = model.plan.layers[GROUPED]
        assert g['fallback'] and g['launches'] == 0 and g['groups'] > 1
        ts, js = model.plan.summary(), want.plan.summary()
        assert ts['n_fallback'] == js['n_fallback'] == 1
        assert ts['fallback_mac_fraction'] == pytest.approx(
            js['fallback_mac_fraction'], rel=1e-12)
        assert 0 < ts['fallback_mac_fraction'] < 1
    else:
        assert model.plan is None
    xt = _t(x)
    reset_counts()
    lg, exits = model.fn_exits(model.params, xt)
    c = counts()
    assert all(v['launches'] == 0 for v in c.values())
    if resident:
        assert sum(v['plain_calls'] for v in c.values()) == \
            sum(sum(seg.values()) for seg in model.segment_launches)
    jl, je = want.fn_exits(want.params, x)
    _close_logits(lg, jl, tol)
    assert sorted(exits) == sorted(je)
    for s in je:
        _close_logits(exits[s], je[s], tol)
    assert torch.equal(model.serve(xt), lg)
    got, got_exits = model.serve_stages(xt)
    assert torch.equal(got, lg)
    assert all(torch.equal(got_exits[s], exits[s]) for s in exits)


def test_grouped_model_served_by_the_scheduler(grouped_model,
                                               grouped_forward):
    """The resident export of the grouped model through the scheduler:
    every request bit for bit against ``fn_exits`` on that request alone
    at the slot geometry."""
    p, cfg, x = grouped_model
    model = texport.export_cnn(from_jax_params(p), cfg, device='cpu',
                               calibrate=_t(x))
    xs = _t(np.random.default_rng(5).standard_normal(
        (12, 16, 16, 3)).astype(np.float32))
    threshold = texport.calibrate_exit_threshold(model, xs[:SLOTS])
    t = np.cumsum(np.random.default_rng(6).exponential(1e-4, size=12))
    done, metrics = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=threshold).run_trace(
        [Request(i, xs[i], float(t[i])) for i in range(12)])
    assert sorted(done) == list(range(12))
    for rid, comp in done.items():
        xb = torch.cat([xs[rid][None],
                        torch.zeros((SLOTS - 1,) + tuple(xs.shape[1:]))])
        logits, ex = model.fn_exits(model.params, xb)
        stage, ans = exit_decisions(logits, ex, threshold)
        assert comp.exit_stage == int(stage[0])
        np.testing.assert_array_equal(comp.logits.view(np.int32),
                                      ans[0].view(np.int32))
    assert metrics.summary()['n_requests'] == 12
