"""The port's depthwise and low-rank serving paths, each as a whole, against
the reference's ``export_cnn(use_pallas=True, calibrate=x)`` (Pallas in
interpret mode) and against their own contracts.

* (a) Depthwise: ``mobilenet-small-cifar`` with exit heads stands in for
  ``mobilenetv2-cifar`` (same block structure, narrower).  Plan scales
  within rtol 1e-5, at most 1% of the int8 carry codes differ at each
  stage boundary, logits within 4e-2 x max|logit| (the reference's own
  Pallas-vs-jnp tolerance, tests/test_export.py).
* (b) Low-rank: ``resnet8-cifar`` factored at energy 0.6, min_rank 2,
  exported with ``select_kernels='fused'`` on both sides.  The plan's
  structure (ranks, fused or chained, launches, MACs) is identical.  Its
  scales are held to rtol 1e-5 in forward order up to the first activation
  whose fake-quant codes differ between the two calibration forwards, and
  to rtol 2e-2 after it: the forward fake-quantizes each activation and
  rank intermediate on a per-tensor abs-max grid, the two frameworks'
  fp32 convs differ in the last ulp, and a code that flips at a rounding
  tie (in the first factored block, on seeds 0 and 1) moves every later
  abs-max.  The flipped codes are held to lie at ties
  (``test_lowrank_calibration_flips_only_at_ties``, which prints the
  readings).  The serving path itself is held on the reference's scales:
  copied into the port's plan, at most 1% of carry codes differ and the
  logits agree within 4e-2 x max|logit|; on the port's own scales the
  logits agree within the same tolerance.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.cnn import MOBILENET_SMALL_CIFAR, RESNET8_CIFAR
from repro.core.export import export_cnn as j_export_cnn
from repro.core.family import CNNFamily as JFamily
from repro.data import SyntheticImages as JImages
from repro.models import cnn as j_cnn
from repro_torch.core.export import (QAct, calibration_tensors,
                                     compare_calibrations, export_cnn)
from repro_torch.interop import from_jax_params
from repro_torch.kernels import counts, reset_counts
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 exit_decisions)

torch.set_num_threads(1)

SLOTS = 8
HW = 16
PATHS = ('depthwise', 'lowrank')
# plan scales up to the first calibration code flip, and after it
SCALE_RTOL_EXACT = 1e-5
SCALE_RTOL = {'depthwise': 1e-5, 'lowrank': 2e-2}
TIE_TOL = 1e-4            # a flipped code's x/scale from a rounding tie
PLAN_KEYS = ('kind', 'depthwise', 'factored', 'fused', 'fallback', 'stride',
             'groups', 'w_shape', 'rank', 'kernel', 'launches', 'in_shape',
             'out_shape', 'macs')
SUMMARY_KEYS = ('n_layers', 'kernel_launches', 'n_exit_heads',
                'exit_head_launches', 'total_macs', 'n_fallback',
                'n_depthwise', 'n_fused_lowrank', 'n_chained_lowrank')


def _reference_params(path, seed=0):
    fam = JFamily(JImages())
    base = MOBILENET_SMALL_CIFAR if path == 'depthwise' else RESNET8_CIFAR
    p = fam.init(jax.random.key(seed), base)
    cfg = base
    if path == 'lowrank':
        p, cfg, _ = fam.factorize(p, cfg, energy=0.6, min_rank=2)
    p, cfg = fam.add_exits(jax.random.key(seed + 2), p, cfg,
                           fam.default_exit_points(cfg))
    return jax.tree.map(np.asarray, p), cfg.replace(w_bits=8, a_bits=8)


def _reference_calibration_tensors(p, cfg, x):
    """The reference's calibration forward (``_compile_layer_plan``'s,
    eager) recorded as ``calibration_tensors`` records the port's:
    ``(name, plan key, fp32 tensor)`` in forward order."""
    rec = []

    def add(name, key, v):
        rec.append((name, key, torch.from_numpy(np.array(v))))

    def conv_fn(p, cx, *, stride=1, quant=(0, 0), groups=1, name=None):
        add(name, 'sx', cx)
        if 'u' in p:
            mid = j_cnn.conv(p['u'], cx, stride=stride, quant=quant,
                             groups=groups)
            add(name, 'h_scale', mid)
            y = j_cnn.conv(p['v'], mid, quant=quant)
        else:
            y = j_cnn.conv(p, cx, stride=stride, quant=quant, groups=groups)
        add(name, 'out_scale', y)
        return y

    def fc_fn(p, cx, *, quant=(0, 0), name=None):
        add(name, 'sx', cx)
        if 'u' in p:
            mid = j_cnn.fc(p['u'], cx, quant=quant)
            add(name, 'h_scale', mid)
            return j_cnn.fc(p['v'], mid, quant=quant)
        return j_cnn.fc(p, cx, quant=quant)

    def glue_fn(np_, y, *, act=None, skip=None, name=None):
        h = j_cnn.norm_act(np_, y, act=act, skip=skip)
        add(name, 'glue', h)
        return h

    j_cnn.cnn_forward(jax.tree.map(jax.numpy.asarray, p), cfg,
                      jax.numpy.asarray(x), collect_exits=True,
                      conv_fn=conv_fn, fc_fn=fc_fn, glue_fn=glue_fn)
    return rec


def _plan_scale(plan, name, key):
    return plan.glues[name] if key == 'glue' else plan.layers[name][key]


@pytest.fixture(scope='module', params=PATHS)
def path(request):
    """(name, params, cfg, x, port model, reference model, reference stage
    outputs [(exits, carry), ..., logits])."""
    name = request.param
    p, cfg = _reference_params(name)
    x = np.random.default_rng(0).standard_normal(
        (SLOTS, HW, HW, 3)).astype(np.float32)
    model = export_cnn(from_jax_params(p), cfg, device='cpu',
                       calibrate=torch.from_numpy(x), select_kernels='fused')
    ref = j_export_cnn(p, cfg, use_pallas=True, calibrate=x,
                       select_kernels='fused')
    outs, h = [], x
    for k in range(ref.n_stages - 1):
        exits, h = ref.run_stage(k, h)
        outs.append((exits, h))
    outs.append(ref.run_stage(ref.n_stages - 1, h))
    return name, p, cfg, x, model, ref, outs


def _port_on_reference_scales(path):
    """A port model whose plan carries the reference's scales."""
    _, p, cfg, x, _, ref, _ = path
    model = export_cnn(from_jax_params(p), cfg, device='cpu',
                       calibrate=torch.from_numpy(x), select_kernels='fused')
    for n, e in ref.plan.layers.items():
        for key in ('sx', 'out_scale', 'h_scale'):
            if key in e:
                model.plan.layers[n][key] = e[key]
    model.plan.glues.update(ref.plan.glues)
    return model


def test_plan_matches_reference(path):
    """Structure identical; scales in forward order within 1e-5 up to the
    first calibration code flip (every scale on the depthwise path), and
    within SCALE_RTOL after it."""
    name, p, cfg, x, model, ref, _ = path
    want, got = ref.plan, model.plan
    assert set(got.layers) == set(want.layers)
    assert set(got.glues) == set(want.glues)
    for n, e in want.layers.items():
        g = got.layers[n]
        for key in PLAN_KEYS:
            assert g.get(key) == e.get(key), (n, key)
        if e.get('selection'):
            assert g['selection']['choice'] == e['selection']['choice'], n
        for key in ('sx', 'out_scale', 'h_scale'):
            assert (g.get(key) is None) == (e.get(key) is None), (n, key)
    port_rec = calibration_tensors(from_jax_params(p), cfg,
                                   torch.from_numpy(x))
    order = [r[:2] for r in port_rec]
    assert len(set(order)) == len(order)
    assert set(order) == {(n, k) for n, e in want.layers.items()
                          for k in ('sx', 'out_scale', 'h_scale')
                          if e.get(k) is not None} | \
        {(n, 'glue') for n in want.glues}
    flip = compare_calibrations(_reference_calibration_tensors(p, cfg, x),
                                port_rec)['flip']
    for i, (n, key) in enumerate(order):
        rtol = SCALE_RTOL_EXACT if flip is None or i <= flip \
            else SCALE_RTOL[name]
        np.testing.assert_allclose(_plan_scale(got, n, key),
                                   _plan_scale(want, n, key), rtol=rtol,
                                   err_msg=f'{n} {key}')
    s_want, s_got = ref.summary(), model.summary()
    for key in SUMMARY_KEYS:
        assert s_got[key] == s_want[key], key
    assert set(s_got['lowrank_selection']) == set(s_want['lowrank_selection'])
    if name == 'depthwise':
        assert s_got['n_depthwise'] == len(MOBILENET_SMALL_CIFAR.stage_blocks)
        for n, e in got.layers.items():
            if e.get('depthwise'):
                assert e['w_shape'][2] == 1 and e['groups'] == e['w_shape'][3]
    else:
        assert s_got['n_fused_lowrank'] > 0


@pytest.mark.parametrize('seed', [0, 1])
def test_lowrank_calibration_flips_only_at_ties(seed):
    """Factored resnet8's two calibration forwards, reference and port,
    per seed: every scale agrees within 1e-5 up to the first activation
    whose fake-quant codes differ; there each differing code moves one step
    and sat within TIE_TOL of a rounding tie; later scales agree within
    SCALE_RTOL.  Prints the readings."""
    p, cfg = _reference_params('lowrank', seed)
    x = np.random.default_rng(seed).standard_normal(
        (SLOTS, HW, HW, 3)).astype(np.float32)
    c = compare_calibrations(
        _reference_calibration_tensors(p, cfg, x),
        calibration_tensors(from_jax_params(p), cfg, torch.from_numpy(x)))
    rel = c['rel']
    cut = len(rel) if c['flip'] is None else c['flip'] + 1
    before, after = max(rel[:cut]), max(rel[cut:], default=0.0)
    print(f'seed {seed}: scales up to the first code flip within '
          f'{before:.3e}; first flip '
          f"{ {k: v for k, v in c.items() if k != 'rel'} }; "
          f'the {len(rel) - cut} scales after it within {after:.3e}')
    assert before <= SCALE_RTOL_EXACT
    if c['flip'] is not None:
        assert c['step'] == 1 and c['tie'] <= TIE_TOL, c
    assert after <= SCALE_RTOL['lowrank']


def test_carry_and_logits_match_reference(path):
    name, _, _, x, own, _, outs = path
    model = own if name == 'depthwise' else _port_on_reference_scales(path)
    th = torch.from_numpy(x)
    got_exits = {}
    for k, (want_exits, jh) in enumerate(outs[:-1]):
        seg_exits, th = model.run_stage(k, th)
        got_exits.update(seg_exits)
        assert isinstance(th, QAct) and th.q.dtype == torch.int8
        np.testing.assert_allclose(th.scale, jh.scale, rtol=1e-5)
        differ = np.mean(th.q.numpy() != np.asarray(jh.q))
        assert differ <= 0.01, f'stage {k}: {differ:.2%} of codes differ'
        for s, a in want_exits.items():
            a = np.asarray(a)
            np.testing.assert_allclose(
                got_exits[s].numpy(), a, rtol=0,
                atol=4e-2 * max(float(np.max(np.abs(a))), 1.0))
    want = np.asarray(outs[-1])
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(model.run_stage(model.n_stages - 1, th)
                               .numpy(), want, rtol=0, atol=4e-2 * scale)
    # the port's own calibration serves within the same tolerance
    np.testing.assert_allclose(own.serve(torch.from_numpy(x)).numpy(), want,
                               rtol=0, atol=4e-2 * scale)


def test_segment_launches_per_kernel(path):
    """Each segment runs exactly its plan share of each kernel (the plain
    versions stand in for the kernels on CPU tensors and count the same
    way), and the shares add up to the monolithic fn_exits."""
    name, _, _, x, model, _, _ = path
    used = {'depthwise': 'depthwise_conv', 'lowrank': 'lowrank_conv'}[name]
    assert any(used in seg for seg in model.segment_launches)
    h = torch.from_numpy(x)
    total = {}
    for k in range(model.n_stages):
        reset_counts()
        out = model.run_stage(k, h)
        plan = model.segment_launches[k]
        assert {n: c['plain_calls'] for n, c in counts().items()
                if c['plain_calls']} == plan, k
        for n, c in plan.items():
            total[n] = total.get(n, 0) + c
        if k < model.n_stages - 1:
            h = out[1]
    reset_counts()
    model.fn_exits(model.params, torch.from_numpy(x))
    assert {n: c['plain_calls'] for n, c in counts().items()
            if c['plain_calls']} == total
    s = model.summary()
    assert sum(total.values()) == s['kernel_launches'] + \
        s['exit_head_launches']


@pytest.mark.parametrize('path', ['lowrank'], indirect=True)
def test_fused_and_chained_exports_agree(path):
    """The fused lowering and the forced chained one serve the same
    numbers bit for bit; the chained plan pays one more launch per fused
    layer, all on quant_matmul."""
    _, p, cfg, x, fused, _, _ = path
    xt = torch.from_numpy(x)
    chained = export_cnn(from_jax_params(p), cfg, device='cpu',
                         calibrate=xt, fuse_lowrank=False)
    sf, sc = fused.summary(), chained.summary()
    assert sc['n_fused_lowrank'] == 0
    assert sc['n_chained_lowrank'] == sf['n_chained_lowrank'] + \
        sf['n_fused_lowrank']
    assert sc['kernel_launches'] == sf['kernel_launches'] + \
        sf['n_fused_lowrank']
    for n, e in fused.plan.layers.items():
        assert chained.plan.layers[n]['sx'] == e['sx']
    lf, ef = fused.fn_exits(fused.params, xt)
    lc, ec = chained.fn_exits(chained.params, xt)
    assert torch.equal(lf.view(torch.int32), lc.view(torch.int32))
    for s in ef:
        assert torch.equal(ef[s].view(torch.int32), ec[s].view(torch.int32))


@pytest.mark.parametrize('path', ['lowrank'], indirect=True)
def test_fused_factors_are_stored_k_major(path):
    """The export stores every fused layer's u and v K-major (the layout
    the lowrank_conv kernels read, so serving relays nothing), with the
    reference's values; the same model on row-major copies of the factors
    serves the same bits."""
    from repro_torch.core.export import _resolve_layer_params
    from repro_torch.core.quantization import quantize_params_for_serving
    from repro_torch.kernels.quant_matmul import k_major
    _, p, cfg, x, model, _, _ = path
    fresh = quantize_params_for_serving(from_jax_params(p), bits=8)
    fused = [n for n, e in model.plan.layers.items() if e.get('fused')]
    assert fused
    row_major = export_cnn(from_jax_params(p), cfg, device='cpu',
                           calibrate=torch.from_numpy(x),
                           select_kernels='fused')
    for n in fused:
        leaf = _resolve_layer_params(model.params, n)
        want = _resolve_layer_params(fresh, n)
        r = model.plan.layers[n]['rank']
        for half in ('u', 'v'):
            w = leaf[half]['w_q']
            assert torch.equal(w, want[half]['w_q'])
            w2 = w.reshape(-1, w.shape[-1])
            assert k_major(w2) and w2.stride() == (1, w2.shape[0])
            assert not w.is_contiguous()
            _resolve_layer_params(row_major.params, n)[half]['w_q'] = \
                w.contiguous()
        assert leaf['u']['w_q'].reshape(-1, r).stride()[0] == 1
    xt = torch.from_numpy(x)
    lk, ek = model.fn_exits(model.params, xt)
    lr, er = row_major.fn_exits(row_major.params, xt)
    assert torch.equal(lk.view(torch.int32), lr.view(torch.int32))
    for s in ek:
        assert torch.equal(ek[s].view(torch.int32), er[s].view(torch.int32))


@pytest.mark.parametrize('path', ['lowrank'], indirect=True)
def test_model_selection_prices_the_h100_kernels(path):
    """``select_kernels='model'`` prices every factored conv inside the
    envelope with the H100 cost model and records why."""
    _, p, cfg, x, _, _, _ = path
    model = export_cnn(from_jax_params(p), cfg, device='cpu',
                       calibrate=torch.from_numpy(x[:2]))
    sel = model.summary()['lowrank_selection']
    assert sel
    for n, s in sel.items():
        assert s['choice'] in ('fused', 'chained')
        assert s['why'].startswith('modeled') or 'envelope' in s['why'], n
        e = model.plan.layers[n]
        assert e['fused'] == (s['choice'] == 'fused')
        assert e['launches'] == (1 if e['fused'] else 2)


def test_scheduler_bit_exact_vs_request_alone(path):
    _, _, _, _, model, _, _ = path
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (12, HW, HW, 3)).astype(np.float32))
    t = np.cumsum(np.random.default_rng(6).exponential(1e-4, size=12))
    from repro_torch.core.export import calibrate_exit_threshold
    threshold = calibrate_exit_threshold(model, xs[:SLOTS])
    completions, _ = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=threshold).run_trace(
            [Request(i, xs[i], float(t[i])) for i in range(12)])
    assert sorted(completions) == list(range(12))
    for rid, c in completions.items():
        xb = torch.cat([xs[rid][None],
                        torch.zeros((SLOTS - 1,) + tuple(xs.shape[1:]))])
        logits, exits = model.fn_exits(model.params, xb)
        stage, ans = exit_decisions(logits, exits, threshold)
        assert c.exit_stage == int(stage[0])
        np.testing.assert_array_equal(c.logits.view(np.int32),
                                      ans[0].view(np.int32))
