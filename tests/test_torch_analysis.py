"""The port's analyzer (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), on the CPU, where the kernel wrappers run
their plain versions and record the same calls and launch plans the card
runs.

* The rule registry round-trips and validates as the reference's does.
* ``order-dag``: the port's findings equal the reference's, field for
  field, on all 120 orders of DPLQE and on QP, PQP, DZ, QL and LQ; so do
  ``Pipeline.verify_order`` and ``from_sequence(verify_order=True)``.
* Every builtin rule has a mutant (``analysis/mutations.py``) that it
  catches; ``MUTANTS`` covers every builtin.
* Clean W8A8 exports with exit heads (resnet8, vgg8, mobilenet-small,
  factored resnet8; two 16 x 16 images) are green on every rule that can
  run, and the reference's export of the same parameters (its jnp path)
  gets the same verdict under the rules it can run (all but its
  ``vmem-fit``, which dies under this jax, ROADMAP C); ``op-traffic``'s
  measured bytes equal its prediction exactly on each.
* ``export_cnn(verify=)``, ``AnalysisError`` carrying its report, and
  ``serve_cnn --server --verify`` printing the report.
* chip_smoke's C 2 check (``static_sites``, ``fed_check``): a code nudged
  across a rounding tie passes, one moved two steps or far from a tie
  fails.

The exports are built once per kind (module-scope fixture); the
reference's eager calibration forward takes most of the file's time,
about 65 s on one core.
"""
import dataclasses
import importlib.util
import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import AnalysisError as JAnalysisError
from repro.analysis import check as j_check
from repro.analysis import registered_rules as j_registered_rules
from repro.configs import cnn as jcnn
from repro.core.chain import Pipeline as JPipeline
from repro.core.export import export_cnn as j_export_cnn
from repro_torch import kernels
from repro_torch.analysis import (AnalysisError, AnalysisReport, AnalysisRule,
                                  Finding, check, get_rule, record_run,
                                  register_rule, registered_rules,
                                  unregister_rule)
from repro_torch.analysis import traffic
from repro_torch.analysis.mutations import MUTANTS
from repro_torch.configs import cnn as tcnn
from repro_torch.core import planner
from repro_torch.core.chain import Pipeline
from repro_torch.core.export import export_cnn
from repro_torch.core import family as tfamily
from repro_torch.data import SyntheticImages
from repro_torch.interop import to_numpy
from repro_torch.kernels.depthwise_conv import depthwise_conv
from repro_torch.kernels.lowrank_conv import lr_plan
from repro_torch.kernels.quant_matmul import qmm_plan

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILTINS = ('int8-residency', 'smem-fit', 'launch-budget', 'stage-carry',
            'order-dag', 'op-traffic', 'placement-consistency',
            'trace-invariants')
KINDS = ('resnet8-cifar', 'vgg8-cifar', 'mobilenet-small-cifar',
         'resnet8-factored')


def _findings(report):
    return [(f.rule, f.severity, f.message, f.where)
            for f in report.findings]


# ------------------------------------------------------------ rule registry


def test_rule_registry_round_trip():
    rule = AnalysisRule(key='always-green', severity='info', requires=(),
                        doc='fires nothing', fn=lambda ctx, r: [])
    register_rule(rule)
    try:
        assert get_rule('always-green') is rule
        assert 'always-green' in registered_rules()
        with pytest.raises(ValueError, match='already registered'):
            register_rule(rule)
        register_rule(rule, replace=True)          # explicit shadowing ok
        rep = check(rules=('always-green',), target='nothing')
        assert rep.checked == ('always-green',) and rep.ok
    finally:
        assert unregister_rule('always-green') is rule
    assert 'always-green' not in registered_rules()
    with pytest.raises(KeyError, match='not registered'):
        unregister_rule('always-green')
    with pytest.raises(KeyError, match='unknown rule'):
        get_rule('no-such-rule')


@pytest.mark.parametrize('bad', [
    dict(key='CamelCase', severity='error', requires=(), doc='', fn=len),
    dict(key='x', severity='fatal', requires=(), doc='', fn=len),
    dict(key='x', severity='error', requires=('pallas',), doc='', fn=len),
    dict(key='x', severity='error', requires=(), doc='', fn=None),
])
def test_register_rule_validates(bad):
    with pytest.raises(ValueError):
        register_rule(AnalysisRule(**bad))


def test_builtins_registered_and_each_has_a_mutant():
    assert set(registered_rules()) == set(BUILTINS) == set(MUTANTS)


def test_unsatisfiable_rules_skip_visibly_and_reports_serialize():
    rep = check()                          # no model, no sequence
    assert rep.checked == () and rep.ok
    assert {k for k, _ in rep.skipped} == set(registered_rules())
    rep = check(sequence='QP')
    d = rep.to_dict()
    assert json.loads(json.dumps(d)) == d
    assert d['ok'] is False and d['findings'][0]['rule'] == 'order-dag'
    assert 'FAIL' in str(rep) and 'P->Q' in str(rep)
    with pytest.raises(ValueError, match='unknown severity'):
        Finding('r', 'fatal', 'm')


# ----------------------------------------------------------------- order-dag


_ORDERS = [''.join(p) for p in itertools.permutations('DPLQE')]


@pytest.mark.parametrize('seq', _ORDERS + ['QP', 'PQP', 'DZ', 'QL', 'LQ'])
def test_order_dag_findings_equal_the_reference(seq):
    got = check(sequence=seq, rules=('order-dag',))
    want = j_check(sequence=seq, rules=('order-dag',))
    assert _findings(got) == _findings(want)
    assert got.ok == want.ok


def test_order_dag_greens_exactly_the_orders_the_dag_allows():
    edges = planner.theoretical_dag('DPLQE')
    green = [s for s in _ORDERS
             if check(sequence=s, rules=('order-dag',)).ok]
    assert green == [s for s in _ORDERS
                     if all(s.index(a) < s.index(b) for a, b in edges)]
    assert green == ['DPLQE', 'DPQLE']
    (f,) = check(sequence='QP').by_rule('order-dag')
    assert f.where == 'P->Q' and "'Q' before 'P'" in f.message
    assert check(sequence='DZ').ok         # an unknown key only warns


@pytest.mark.parametrize('seq,repeats', [('DPLQE', False), ('DPQE', False),
                                         ('QP', False), ('PQP', True)])
def test_pipeline_verify_order_matches_the_reference(seq, repeats):
    pipe = Pipeline.from_sequence(seq, allow_repeats=repeats)
    jpipe = JPipeline.from_sequence(seq, allow_repeats=repeats)
    got, want = pipe.verify_order(), jpipe.verify_order()
    assert _findings(got) == _findings(want) and got.target == want.target
    if want.ok:
        assert Pipeline.from_sequence(seq, allow_repeats=repeats,
                                      verify_order=True).sequence == seq
    else:
        with pytest.raises(AnalysisError) as ei:
            Pipeline.from_sequence(seq, allow_repeats=repeats,
                                   verify_order=True)
        with pytest.raises(JAnalysisError):
            JPipeline.from_sequence(seq, allow_repeats=repeats,
                                    verify_order=True)
        assert ei.value.report.by_rule('order-dag')[0].where == 'P->Q'


# ------------------------------------------------------ red on every mutant


@pytest.mark.parametrize('key', sorted(MUTANTS))
def test_mutant_is_caught_by_exactly_its_rule(key):
    kwargs = MUTANTS[key]()
    assert kwargs['rules'] == (key,)       # verdict attributable to one rule
    rep = check(**kwargs)
    assert rep.checked == (key,)
    errs = [f for f in rep.by_rule(key) if f.severity == 'error']
    assert errs, f'{key} mutant produced no error finding:\n{rep}'
    with pytest.raises(AnalysisError) as ei:
        rep.raise_if_errors()
    assert ei.value.report is rep


def test_smem_fit_mutant_never_reaches_a_launcher():
    """The mutant's plan is over the budget; its call runs the plain
    version on the CPU and records that plan, and the real plan function
    is back in place afterwards."""
    from repro_torch.kernels import lowrank_conv as lr
    kwargs = MUTANTS['smem-fit']()
    before = lr.lowrank_conv.launches
    run = record_run(kwargs['model'].fn, None, kwargs['x'])
    (call,) = run.calls
    assert call.plain and call.route == 'wgmma'
    assert call.smem_bytes > lr.SMEM_BUDGET and call.plan[3] == 8
    assert lr.lowrank_conv.launches == before and lr.lr_plan is lr_plan


# --------------------------------------------- green on clean exports


_MODELS = {}


def _model(kind):
    """(port params, reference params as numpy, reference cfg, port cfg) of
    ``kind``, drawn by the port's family from seed 0, with exit heads at
    the default stages, W8A8; ``resnet8-factored`` is resnet8 after
    ``factorize(energy=0.6, min_rank=2)``."""
    if kind not in _MODELS:
        name = 'resnet8-cifar' if kind == 'resnet8-factored' else kind
        cfg = tcnn.CNN_REGISTRY[name]
        fam = tfamily.CNNFamily(SyntheticImages(), device='cpu')
        p = fam.init(torch.Generator().manual_seed(0), cfg)
        if kind == 'resnet8-factored':
            p, cfg, _ = fam.factorize(p, cfg, energy=0.6, min_rank=2)
        p, cfg = fam.add_exits(torch.Generator().manual_seed(1), p, cfg,
                               fam.default_exit_points(cfg))
        cfg = cfg.replace(w_bits=8, a_bits=8)
        _MODELS[kind] = (p, to_numpy(p),
                         jcnn.CNNConfig(**dataclasses.asdict(cfg)), cfg)
    return _MODELS[kind]


def _images():
    return np.random.default_rng(3).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)


@pytest.fixture(scope='module', params=KINDS)
def clean(request):
    """(kind, the port's export, the port's report, the reference's
    report) of one clean export, built once."""
    tp, jp, jc, tc = _model(request.param)
    x = _images()
    model = export_cnn(tp, tc, device='cpu', calibrate=torch.from_numpy(x))
    ref = j_export_cnn(jax.tree.map(jnp.asarray, jp), jc, use_pallas=False,
                       calibrate=x)
    j_rules = tuple(k for k in j_registered_rules() if k != 'vmem-fit')
    return (request.param, model, check(model, x=torch.from_numpy(x)),
            j_check(ref, x=x, rules=j_rules))


def test_clean_export_green_and_the_reference_agrees(clean):
    kind, model, rep, ref = clean
    assert rep.ok, str(rep)
    assert ref.ok == rep.ok, str(ref)
    assert set(rep.checked) == {'int8-residency', 'smem-fit',
                                'launch-budget', 'stage-carry', 'op-traffic'}
    assert dict(rep.skipped) == {
        'order-dag': 'target lacks sequence',
        'placement-consistency': 'target lacks placement',
        'trace-invariants': 'target lacks trace'}
    assert {'int8-residency', 'launch-budget', 'stage-carry'} <= \
        set(ref.checked)
    # the reference's hlo-traffic ran on its jnp path and read a ratio too
    assert any('predicted' in f.message for f in ref.by_rule('hlo-traffic'))


def test_clean_export_op_traffic_is_the_prediction(clean):
    """The bytes one ``fn`` call writes equal ``traffic``'s 'cuda' terms
    exactly, and the kernel calls are those the layer plan counts, every
    one on a plain version with the plan the card would launch."""
    kind, model, rep, _ = clean
    x = torch.from_numpy(_images())
    run = record_run(model.fn, model.params, x)
    main = {n: e for n, e in model.plan.layers.items()
            if not n.startswith('exit')}
    pred = traffic.predicted_hbm_bytes(main, backend='cuda')
    assert run.written_bytes() == pred['predicted_bytes']
    (info,) = [f for f in rep.by_rule('op-traffic') if f.severity == 'info']
    assert '(1.000x: ' in info.message
    assert len(run.calls) == model.plan.summary()['kernel_launches']
    for c in run.calls:
        assert c.plain
        if c.kernel == 'quant_matmul' and c.route == 'wgmma':
            (m, k), (_, n) = c.operands[0][1], c.operands[1][1]
            assert c.plan == qmm_plan(m, n, k)
        if c.kernel == 'lowrank_conv' and c.route == 'wgmma':
            (m, k1), (r, n) = c.operands[0][1], c.operands[2][1]
            assert c.plan == lr_plan(m, k1, r, n)
    assert ('lowrank_conv' in {c.kernel for c in run.calls}) == \
        (kind == 'resnet8-factored')
    assert ('depthwise_conv' in {c.kernel for c in run.calls}) == \
        (kind == 'mobilenet-small-cifar')


def test_op_recorder_leaves_out_the_plain_versions_ops():
    """A depthwise call's plain version convolves in fp32; none of its ops
    is recorded, its output counts once from the call record."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-8, 8, (2, 8, 8, 16), generator=g, dtype=torch.int8)
    w = torch.randint(-8, 8, (3, 3, 1, 16), generator=g, dtype=torch.int8)

    sw = torch.ones(16)

    def fn(p, v):
        return depthwise_conv(v, w, 0.1, sw, out_scale=0.2)
    run = record_run(fn, None, x)
    assert run.ops == () and [c.kernel for c in run.calls] == [
        'depthwise_conv']
    assert run.written_bytes() == 2 * 8 * 8 * 16
    assert not kernels.inside_wrapper()
    with kernels.recording() as calls:
        pass
    fn(None, x)                              # no block open: nothing kept
    assert calls == []


# --------------------------------------------------- export and CLI wiring


def test_export_cnn_verify_attaches_report_and_strict_raises():
    params, _, _, tc = _model('resnet8-cifar')
    x = torch.from_numpy(_images())
    with pytest.raises(ValueError, match='verify'):
        export_cnn(params, tc, device='cpu', calibrate=x, verify='bad')
    m = export_cnn(params, tc, device='cpu', calibrate=x, verify='strict')
    assert isinstance(m.analysis, AnalysisReport) and m.analysis.ok
    assert m.summary()['analysis']['ok'] is True
    m2 = export_cnn(params, tc, device='cpu', calibrate=x)
    assert m2.analysis is None and 'analysis' not in m2.summary()
    probe = AnalysisRule(key='always-red', severity='error', requires=(),
                         doc='', fn=lambda ctx, r: [r.finding('boom')])
    register_rule(probe)
    try:
        warned = export_cnn(params, tc, device='cpu', calibrate=x,
                            verify='warn')
        assert not warned.analysis.ok
        assert warned.summary()['analysis']['ok'] is False
        with pytest.raises(AnalysisError) as ei:
            export_cnn(params, tc, device='cpu', calibrate=x,
                       verify='strict')
        assert ei.value.report.by_rule('always-red')
    finally:
        unregister_rule('always-red')


def test_serve_cnn_verify_prints_the_report():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    r = subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.serve_cnn', '--server',
         '--config', 'resnet8-cifar', '--requests', '8', '--steps', '0',
         '--device', 'cpu', '--verify'],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'analysis[resnet8-cifar]: OK' in r.stdout
    assert 'SKIP  order-dag: target lacks sequence' in r.stdout
    assert 'served 8 requests' in r.stdout


# --------------------------------------------- chip_smoke's C 2 check


@pytest.fixture(scope='module')
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nudged(sites, site, i, code, t):
    """``sites`` with element ``i`` of site ``site`` given ``code`` and
    x/s ``t``."""
    name, q, ts = sites[site]
    q, ts = q.clone(), ts.clone()
    q.view(-1)[i] = code
    ts.view(-1)[i] = t
    return sites[:site] + [(name, q, ts)] + sites[site + 1:]


def test_c2_fed_check_passes_a_tie_flip_and_fails_the_rest(chip_smoke):
    """A stand-in card: the CPU export with one glue code moved (its x/s
    put at ``card_t``) and the move carried downstream, as a card whose
    fp32 glue summed to the other side of a value would carry it."""
    params, _, _, tc = _model('resnet8-cifar')
    x = torch.from_numpy(_images())
    card = export_cnn(params, tc, device='cpu', calibrate=x)
    cpu = export_cnn(params, tc, device='cpu', calibrate=x)
    lg, sites, _ = chip_smoke.static_sites(torch, lambda: card.serve(x))
    assert [s[0] for s in sites] == [
        'stem', 'stem.norm', 's0b0.n1', 's0b0.n2', 's1b0.n1', 's1b0.n2',
        's2b0.n1', 's2b0.n2', 'head']
    fed = chip_smoke.fed_check(torch, lg, sites, lambda: cpu.serve(x))
    assert fed['ok'] and fed['flips'] == 0 and fed['diff'] == 0.0
    # a code in the middle of its step: the CPU's x/s is half a step from
    # either tie, so only the card's x/s can sit at one
    site = 3
    _, q, t = sites[site]
    i = int(torch.argmin((t - torch.round(t)).abs().view(-1)
                         + 1e3 * (q.view(-1).abs() > 100).float()))
    k, own = int(q.view(-1)[i]), float(t.view(-1)[i])
    cases = [(k + 1, k + 0.5 + 1e-6, True),   # across the tie: passes
             (k + 2, k + 1.5 + 1e-6, False),  # two steps: fails
             (k + 1, own + 1.0, False)]       # far from a tie: fails
    for code, card_t, ok in cases:
        moved = _nudged(sites, site, i, code, card_t)
        lg_card, card_sites, _ = chip_smoke.static_sites(
            torch, lambda: card.serve(x), forced=moved[:site + 1])
        card_sites = _nudged(card_sites, site, i, code, card_t)
        got = chip_smoke.fed_check(torch, lg_card, card_sites,
                                   lambda: cpu.serve(x))
        assert got['ok'] == ok, (code, card_t, got)
        assert got['flips'] == 1 and got['diff'] == 0.0
        first = got['first']
        assert (first['site'], first['first'], first['at']) == (
            site, i, 's0b0.n2')
