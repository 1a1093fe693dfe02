"""The port's observability layer held against the JAX package: the Chrome
trace round trip (``load_chrome_trace``), ``check_trace`` on clean traces
and on each corruption of the reference's ``tests/test_obs.py`` (the
port's violation messages equal the reference validator's on the same
spans and completions), the traces of the port's schedulers and replica
pool under a chaos kill, and measure-mode kernel selection
(``export_cnn(select_kernels='measure')``): its ``kernel.launch`` spans
and the measured-vs-modeled ``lowering_cost_delta`` block; and
``serve_cnn --server --deadline-ms --chaos --trace`` on resnet8, whose
trace file is read back and checked.  On the CPU
measure mode times the kernels' plain versions, so the tests check the
structure, not which lowering wins.

The port's resnet8 export (8 slots, 16 x 16 images) is built once per
module; the reference validator reads the port's spans directly.  About
20 s on one CPU worker, 12 s of it the CLI's subprocesses.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.obs import Span as JSpan
from repro.obs import check_trace as j_check_trace
from repro.obs import load_chrome_trace as j_load_chrome_trace
from repro_torch.configs.cnn import RESNET8_CIFAR
from repro_torch.core.export import calibrate_exit_threshold, export_cnn
from repro_torch.core.family import CNNFamily
from repro_torch.data import SyntheticImages
from repro_torch.kernels import counts, reset_counts
from repro_torch.obs import (NULL_TRACER, NullTracer, Span,
                             TraceInvariantError, Tracer, as_tracer,
                             check_trace, load_chrome_trace, spans_to_chrome)
from repro_torch.serving import (ChaosPlan, ContinuousBatchScheduler,
                                 ReplicaPoolScheduler, Request,
                                 StaticBatchScheduler)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 8
HW = 16
COSTS = [4e-3, 2e-3, 1e-3]


@pytest.fixture(scope='module')
def exported():
    fam = CNNFamily(SyntheticImages(), device='cpu')
    params = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(2), params,
                                RESNET8_CIFAR,
                                fam.default_exit_points(RESNET8_CIFAR))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    calib = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (SLOTS, HW, HW, 3)).astype(np.float32))
    model = export_cnn(params, cfg, device='cpu', calibrate=calib)
    return model, calibrate_exit_threshold(model, calib)


def _trace(n, rate=2000.0, seed=0):
    xs = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (max(n, 1), HW, HW, 3)).astype(np.float32))
    t = np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n))
    return [Request(i, xs[i], float(t[i])) for i in range(n)]


def _as_ref(spans):
    return [JSpan(s.name, s.t0, s.t1, s.track, s.kind, s.cid, s.args)
            for s in spans]


def _check_both(spans, completions=None):
    """The port's violations, equal to the reference validator's."""
    got = check_trace(spans, completions)
    assert got == j_check_trace(_as_ref(spans), completions)
    return got


# ------------------------------------------------------------ tracer core


def test_null_tracer_is_allocation_free_default():
    assert as_tracer(None) is NULL_TRACER and not NULL_TRACER.enabled
    NULL_TRACER.add('x', 0, 1, track='t')
    NULL_TRACER.async_span('x', 0, 1, track='t', cid=0)
    NULL_TRACER.instant('x', 0, track='t')
    NULL_TRACER.counter('x', 0, 1.0)
    with NULL_TRACER.span('x', track='t'):
        pass
    assert NULL_TRACER.spans == [] and NULL_TRACER.now() == 0.0
    t = Tracer()
    assert as_tracer(t) is t and t.enabled
    assert isinstance(NULL_TRACER, NullTracer)
    with t.span('export.calibrate', track='export', config='c'):
        pass
    (s,) = t.spans
    assert s.name == 'export.calibrate' and s.args == {'config': 'c'}
    assert 0.0 <= s.t0 <= s.t1 and s.dur == s.t1 - s.t0


def _all_kinds():
    t = Tracer()
    t.add('stage.exec', 0.001, 0.005, track='replica0',
          stage=0, live=8, slots=8, rids=[0, 1])
    t.add('failover.restore', 0.005, 0.009, track='replica10', replaced=0)
    t.async_span('request.queue', 0.000, 0.001, track='cohort0', cid=1,
                 requeued=False)
    t.async_span('request.queue', 0.002, 0.004, track='cohort0', cid=1,
                 requeued=True)
    t.instant('compaction', 0.005, track='replica0', stage=0, n_exit=4,
              n_survive=4)
    t.counter('queue_depth', 0.002, 3.0)
    t.add('kernel.launch', 0.0, 2e-5, track='export', variant='fused')
    return t


def test_chrome_roundtrip_all_kinds_matches_reference(tmp_path):
    t = _all_kinds()
    path = str(tmp_path / 'trace.json')
    t.write(path)
    got = load_chrome_trace(path)
    want = j_load_chrome_trace(path)
    assert [(s.name, s.t0, s.t1, s.track, s.kind, s.cid, s.args)
            for s in got] == [(s.name, s.t0, s.t1, s.track, s.kind, s.cid,
                               s.args) for s in want]
    assert load_chrome_trace(json.load(open(path))) == got
    assert sorted(s.name for s in got) == sorted(s.name for s in t.spans)
    for orig in t.spans:
        (g,) = [s for s in got if (s.name, s.t0) == (orig.name,
                                                      pytest.approx(orig.t0))
                and s.args.get('requeued') == orig.args.get('requeued')]
        assert g.kind == orig.kind and g.track == orig.track
        assert g.t1 == pytest.approx(orig.t1, abs=1e-9)
    by_name = {s.name: s for s in got}
    assert by_name['stage.exec'].args['rids'] == [0, 1]
    assert by_name['queue_depth'].args == {'value': 3.0}
    doc = json.load(open(path))
    names = {(e['pid'], e['tid']): e['args']['name']
             for e in doc['traceEvents']
             if e.get('ph') == 'M' and e['name'] == 'thread_name'}
    assert names[(1, 1)] == 'replica0' and names[(1, 2)] == 'replica10'
    procs = {e['pid']: e['args']['name'] for e in doc['traceEvents']
             if e.get('ph') == 'M' and e['name'] == 'process_name'}
    assert procs[1] == 'serving' and procs[2] == 'requests' and \
        procs[3] == 'export'


@pytest.mark.parametrize('drop', ['e', 'b'])
def test_load_chrome_trace_rejects_torn_async(drop):
    doc = spans_to_chrome([Span('request.queue', 0.0, 1.0, 'cohort0',
                                kind='async', cid=5)])
    doc['traceEvents'] = [e for e in doc['traceEvents']
                          if e.get('ph') != drop]
    for load in (load_chrome_trace, j_load_chrome_trace):
        with pytest.raises(ValueError, match='torn async'):
            load(doc)


# ----------------------------------------------------------- check_trace

CLEAN = [
    Span('stage.exec', 0.000, 0.004, 'replica0',
         args={'stage': 0, 'live': 8, 'slots': 8, 'rids': [0]}),
    Span('stage.exec', 0.004, 0.006, 'replica0',
         args={'stage': 1, 'live': 4, 'slots': 8, 'rids': [0]}),
]
CORRUPT = {
    'torn': ([Span('stage.exec', 0.010, 0.008, 'replica1',
                   args={'stage': 0})], 'torn'),
    'overlap': (CLEAN + [Span('stage.exec', 0.002, 0.005, 'replica0',
                              args={'stage': 0, 'rids': [9]})],
                'overlaps'),
    'missing-stage': ([Span('stage.exec', 0.0, 0.001, 'replica0')],
                      'missing "stage"'),
    'non-finite': ([Span('stage.exec', 0.0, math.inf, 'executor0',
                         args={'stage': 0})], 'non-finite'),
    'empty-track': ([Span('stage.exec', 0.0, 0.001, '',
                          args={'stage': 0})], 'empty name/track'),
    'concurrent': ([Span('stage.exec', 0.0, 0.004, 'executor0',
                         args={'stage': 0}),
                    Span('stage.exec', 0.001, 0.003, 'executor0',
                         args={'stage': 1})], 'concurrent'),
}


def test_check_trace_clean():
    assert _check_both(CLEAN) == []


@pytest.mark.parametrize('case', sorted(CORRUPT))
def test_check_trace_each_corruption(case):
    spans, needle = CORRUPT[case]
    got = _check_both(spans)
    assert any(needle in m for m in got), got
    with pytest.raises(TraceInvariantError) as ei:
        check_trace(spans, strict=True)
    assert ei.value.violations == got


def _shift(spans, pick, **change):
    """``spans`` with the span ``pick`` selects rebuilt: each field in
    ``change`` is a function of the old span."""
    out = list(spans)
    i = pick(out)
    s = out[i]
    fields = dict(name=s.name, t0=s.t0, t1=s.t1, track=s.track,
                  kind=s.kind, cid=s.cid, args=s.args)
    fields.update({k: f(s) for k, f in change.items()})
    out[i] = Span(**fields)
    return out


def _last_exec(spans):
    return max(range(len(spans)), key=lambda j: spans[j].t1
               if spans[j].name == 'stage.exec' else -1.0)


def _first_queue(spans):
    return next(j for j, s in enumerate(spans) if s.name == 'request.queue')


def test_check_trace_completion_extents(exported):
    """With completions the span tree must cover each latency exactly, and
    each way of breaking that is caught, in the reference's words."""
    model, thr = exported
    tracer = Tracer()
    comp, _ = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=thr, stage_costs=COSTS,
        tracer=tracer).run_trace(_trace(2 * SLOTS))
    spans = list(tracer.spans)
    assert _check_both(spans, comp) == []
    rid = spans[_first_queue(spans)].cid
    cases = {
        'extent mismatch': _shift(spans, _last_exec,
                                  t1=lambda s: s.t1 + 1.0),
        'first queue span starts': _shift(spans, _first_queue,
                                          t0=lambda s: s.t0 - 1e-3),
        'queue-wait mismatch': _shift(spans, _first_queue,
                                      t1=lambda s: s.t1 + 1e-3),
        'no request.queue span': [s for s in spans
                                  if not (s.name == 'request.queue'
                                          and s.cid == rid)],
        'no stage.exec span': [s for s in spans if s.name != 'stage.exec'],
        'no segment-0 stage.exec': [
            s for s in spans if not (s.name == 'stage.exec'
                                     and s.args['stage'] == 0)],
    }
    for needle, broken in cases.items():
        got = _check_both(broken, comp)
        assert any(needle in m for m in got), (needle, got)


def test_check_trace_reads_a_trace_file(exported, tmp_path):
    model, thr = exported
    tracer = Tracer()
    comp, _ = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=thr, stage_costs=COSTS,
        tracer=tracer).run_trace(_trace(SLOTS + 3))
    path = str(tmp_path / 't.json')
    tracer.write(path)
    assert check_trace(path, comp, strict=True) == []
    assert len(load_chrome_trace(path)) == len(tracer.spans)
    assert j_check_trace(path, comp) == []


# ------------------------------------------------- scheduler integration


def test_schedulers_traces_are_valid(exported):
    model, thr = exported
    reqs = _trace(3 * SLOTS + 5)
    tracer = Tracer()
    comp, _ = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=thr, stage_costs=COSTS,
        tracer=tracer).run_trace(reqs)
    assert len(comp) == len(reqs)
    assert check_trace(tracer, comp, strict=True) == []
    queue = [s for s in tracer.spans if s.name == 'request.queue']
    assert sorted(s.cid for s in queue) == sorted(r.rid for r in reqs)
    assert all(s.track == 'executor0' for s in tracer.spans
               if s.name == 'stage.exec')
    assert any(s.name == 'compaction' for s in tracer.spans)
    tracer = Tracer()
    comp, _ = StaticBatchScheduler(model, slots=SLOTS, threshold=thr,
                                   batch_cost=sum(COSTS),
                                   tracer=tracer).run_trace(_trace(SLOTS + 3))
    assert check_trace(tracer, comp, strict=True) == []


def test_pool_chaos_trace_shows_kill_and_failover(exported):
    """The killed stage.exec is cut at the kill on the victim's track, the
    requeued requests' second queue span starts AT the kill, and
    failover.restore lands on the replacement's track; the full check
    stays green."""
    model, thr = exported
    reqs = _trace(3 * SLOTS, rate=4000.0)
    tracer = Tracer()
    comp, _ = ReplicaPoolScheduler(
        model, slots=SLOTS, threshold=thr, stage_costs=COSTS, replicas=2,
        min_replicas=2, chaos=ChaosPlan(kills=((4e-3, 0),)),
        restore=lambda: model, restore_delay=COSTS[0],
        tracer=tracer).run_trace(reqs)
    assert len(comp) == len(reqs)
    assert _check_both(list(tracer.spans), comp) == []
    killed = [s for s in tracer.spans
              if s.name == 'stage.exec' and s.args.get('killed')]
    assert killed
    (kt,) = {s.track for s in killed}
    restores = [s for s in tracer.spans if s.name == 'failover.restore']
    assert restores and restores[0].track != kt
    assert restores[0].dur == pytest.approx(COSTS[0])
    requeued = [s for s in tracer.spans if s.name == 'request.queue'
                and s.args.get('requeued')]
    assert requeued and all(s.t0 == pytest.approx(killed[0].t1)
                            for s in requeued)
    rid = int(killed[0].args['rids'][0])
    assert len([s for s in tracer.spans
                if s.name == 'request.queue' and s.cid == rid]) == 2


# ------------------------------------------------ export kernel profiling


def _factored():
    fam = CNNFamily(SyntheticImages(), device='cpu')
    params = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    params, cfg, _ = fam.factorize(params, RESNET8_CIFAR, energy=0.6,
                                   min_rank=2)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, HW, HW, 3)).astype(np.float32))
    return params, cfg.replace(w_bits=8, a_bits=8), x


def test_export_measure_mode_emits_kernel_spans():
    """Every factored conv inside the envelope is timed on both lowerings,
    ``reps`` times each, through ``kernel.launch`` spans on track export;
    the selection and the plan's launch count follow the measurement, and
    the summary keeps the measured and the modeled costs side by side."""
    params, cfg, x = _factored()
    tracer = Tracer()
    reset_counts()
    model = export_cnn(params, cfg, device='cpu', calibrate=x,
                       select_kernels='measure', tracer=tracer)
    c = counts()
    assert c['lowrank_conv']['plain_calls'] > 0       # the fused lowering
    assert c['quant_matmul']['plain_calls'] > 0       # the chained one
    cal = [s for s in tracer.spans if s.name == 'export.calibrate']
    assert len(cal) == 1 and cal[0].args['select_kernels'] == 'measure'
    launches = [s for s in tracer.spans if s.name == 'kernel.launch']
    assert {s.args['variant'] for s in launches} == {'fused', 'chained'}
    assert all(s.track == 'export' and s.dur >= 0 for s in launches)
    assert check_trace(tracer) == []
    s = model.plan.summary()
    delta = s['lowering_cost_delta']
    factored = {n for n, e in model.plan.layers.items()
                if e['kind'] == 'conv' and e['factored']}
    assert delta and set(delta) <= factored
    assert {sp.args['layer'] for sp in launches} == set(delta)
    assert len(launches) == 2 * 3 * len(delta)
    for n, d in delta.items():
        e = model.plan.layers[n]
        sel = e['selection']
        assert sel['why'].startswith('measured')
        timed = {v: min(sp.args['us'] for sp in launches
                        if sp.args['layer'] == n and sp.args['variant'] == v)
                 for v in ('fused', 'chained')}
        assert d['measured_fused_us'] == pytest.approx(timed['fused'],
                                                       abs=0.1)
        assert d['measured_chained_us'] == pytest.approx(timed['chained'],
                                                         abs=0.1)
        assert e['fused'] == (sel['fused_us'] <= sel['chained_us'])
        assert e['launches'] == (1 if e['fused'] else 2)
        assert d['fused_measured_over_modeled'] > 0
        assert d['chained_measured_over_modeled'] > 0
        assert d['model_agrees'] == (
            (d['modeled_fused_us'] <= d['modeled_chained_us']) == e['fused'])
    assert s['kernel_launches'] == sum(
        e['launches'] for n, e in model.plan.layers.items()
        if not n.startswith('exit'))
    ref = export_cnn(params, cfg, device='cpu', calibrate=x)
    assert ref.plan.summary()['lowering_cost_delta'] == {}
    for n in delta:
        assert model.plan.layers[n]['selection']['modeled_fused_us'] == \
            ref.plan.layers[n]['selection']['fused_us']
    xs = x.repeat(4, 1, 1, 1)
    torch.testing.assert_close(model.serve(xs), ref.serve(xs), rtol=0,
                               atol=0)


def test_measure_mode_times_nothing_when_nothing_can_fuse():
    params, cfg, x = _factored()
    tracer = Tracer()
    model = export_cnn(params, cfg, device='cpu', calibrate=x,
                       select_kernels='measure', fuse_lowrank=False,
                       tracer=tracer)
    assert not [s for s in tracer.spans if s.name == 'kernel.launch']
    assert model.plan.summary()['lowering_cost_delta'] == {}
    assert model.plan.summary()['n_fused_lowrank'] == 0


# --------------------------------------------------------------- the CLI


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.serve_cnn', '--server',
         '--config', 'resnet8-cifar', '--device', 'cpu', '--steps', '0',
         '--batch', '16', '--slots', '8', *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_serve_cli_slo_chaos_and_trace(tmp_path):
    """The flags run end to end on the CPU.  The stage costs are measured
    on this host's clock, so the deadline is loose enough for any load."""
    out = str(tmp_path / 'trace.json')
    r = _serve_cli('--requests', '32', '--deadline-ms', '5000', '--chaos',
                   '--trace', out)
    assert r.returncode == 0, r.stderr
    assert 'clock=simulated' in r.stdout
    assert 'served 32 requests' in r.stdout and 'late=0' in r.stdout
    assert 'chaos: availability=' in r.stdout and 'kills=1' in r.stdout
    spans = load_chrome_trace(out)
    assert {'stage.exec', 'kill', 'failover.restore',
            'export.calibrate'} <= {s.name for s in spans}
    assert check_trace(spans) == []
    for flag, item in (('--pipeline', 'item 10'), ('--verify', 'item 7')):
        r = _serve_cli('--requests', '8', flag)
        assert r.returncode != 0 and item in r.stderr
