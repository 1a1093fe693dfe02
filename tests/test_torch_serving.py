"""The serving slice of the PyTorch port: export, stage split, scheduler and
CLI, held against the JAX package and against its own contracts.

* The slice as a whole, on resnet8 with exit heads and a calibration batch
  of 8, against the reference's ``export_cnn(use_pallas=True,
  calibrate=x)`` (Pallas in interpret mode): plan scales within rtol 1e-5
  (both sides read them off fp32 forwards whose reductions run in
  different orders); at most 1% of the int8 carry codes differ at each
  stage boundary (a scale or value one ulp apart can round to the
  neighbouring code); logits within the reference's own pallas-vs-jnp
  tolerance, atol 4e-2 x max|logit| (tests/test_export.py).
* The scheduler's contract: every request bit-exact against the port's
  own monolithic ``fn_exits`` on that request alone at the slot geometry.
* The package imports no JAX and nothing of the JAX package.
"""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.cnn import RESNET8_CIFAR
from repro.core.export import export_cnn as j_export_cnn
from repro.core.export import early_exit_batch as j_early_exit_batch
from repro.core.family import CNNFamily as JFamily
from repro.data import SyntheticImages as JImages
from repro_torch.core.export import (QAct, calibrate_exit_threshold,
                                     early_exit_batch, export_cnn)
from repro_torch.interop import from_jax_params
from repro_torch.kernels import counts, reset_counts
from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                 exit_decisions)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 8
HW = 16


@pytest.fixture(scope='module')
def setup():
    fam = JFamily(JImages())
    p = fam.init(jax.random.key(0), RESNET8_CIFAR)
    p, cfg = fam.add_exits(jax.random.key(2), p, RESNET8_CIFAR,
                           fam.default_exit_points(RESNET8_CIFAR))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    p = jax.tree.map(np.asarray, p)
    x = np.random.default_rng(0).standard_normal(
        (SLOTS, HW, HW, 3)).astype(np.float32)
    model = export_cnn(from_jax_params(p), cfg, device='cpu',
                       calibrate=torch.from_numpy(x))
    return p, cfg, x, model


@pytest.fixture(scope='module')
def reference(setup):
    p, cfg, x, _ = setup
    return j_export_cnn(p, cfg, use_pallas=True, calibrate=x)


# ---------------------------------------------------- the slice as a whole


def test_plan_scales_match_reference(setup, reference):
    _, _, _, model = setup
    want, got = reference.plan, model.plan
    assert set(got.layers) == set(want.layers)
    assert set(got.glues) == set(want.glues)
    for name, e in want.layers.items():
        for key in ('sx', 'out_scale'):
            if e[key] is None:
                assert got.layers[name][key] is None
            else:
                np.testing.assert_allclose(got.layers[name][key], e[key],
                                           rtol=1e-5, err_msg=name)
        assert got.layers[name]['launches'] == e['launches']
    for name, s in want.glues.items():
        np.testing.assert_allclose(got.glues[name], s, rtol=1e-5,
                                   err_msg=name)
    s_want, s_got = reference.summary(), model.summary()
    for key in ('n_layers', 'kernel_launches', 'n_exit_heads',
                'exit_head_launches', 'total_macs', 'n_fallback'):
        assert s_got[key] == s_want[key], key


def test_stage_carry_and_logits_match_reference(setup, reference):
    _, _, x, model = setup
    jh, th = x, torch.from_numpy(x)
    for k in range(model.n_stages - 1):
        _, jh = reference.run_stage(k, jh)
        _, th = model.run_stage(k, th)
        assert isinstance(th, QAct) and th.q.dtype == torch.int8
        np.testing.assert_allclose(th.scale, jh.scale, rtol=1e-5)
        differ = np.mean(th.q.numpy() != np.asarray(jh.q))
        assert differ <= 0.01, f'stage {k}: {differ:.2%} of codes differ'
    want_logits, want_exits = reference.fn_exits(reference.params, x)
    got_logits, got_exits = model.fn_exits(model.params, torch.from_numpy(x))
    assert set(got_exits) == set(want_exits)
    for a, b in [(want_logits, got_logits)] + [
            (want_exits[s], got_exits[s]) for s in want_exits]:
        a = np.asarray(a)
        scale = max(float(np.max(np.abs(a))), 1.0)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=4e-2 * scale)


def test_early_exit_batch_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((16, 10)).astype(np.float32) * 3
    exits = {s: rng.standard_normal((16, 10)).astype(np.float32) * 3
             for s in (0, 1)}
    want = j_early_exit_batch(logits, exits, 0.5)
    got = early_exit_batch(torch.from_numpy(logits),
                           {s: torch.from_numpy(v) for s, v in exits.items()},
                           0.5)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_serve_early_exit_applies_the_exit_rule(setup):
    _, _, x, model = setup
    xt = torch.from_numpy(x)
    logits, exits = model.fn_exits(model.params, xt)
    for threshold in (0.0, 0.3, 2.0):
        pred, stage = model.serve_early_exit(xt, threshold=threshold)
        want = early_exit_batch(logits, exits, threshold)
        assert torch.equal(pred, want[0]) and torch.equal(stage, want[1])
    pred, stage = model.serve_early_exit(xt[:0])
    assert pred.shape == (0,) and stage.shape == (0,)
    assert torch.equal(model.serve(xt), logits)


# -------------------------------------------------- stage split + scheduler


def test_stage_split_bit_exact_vs_monolithic(setup):
    _, cfg, x, model = setup
    assert model.n_stages == len(cfg.exit_stages) + 1
    xt = torch.from_numpy(x[::-1].copy())
    logits, exits = model.fn_exits(model.params, xt)
    s_logits, s_exits = model.serve_stages(xt)
    assert torch.equal(s_logits, logits)
    for s in exits:
        assert torch.equal(s_exits[s], exits[s])


def test_segment_launches_account_the_plan(setup):
    """Each segment runs exactly its share of the plan's launches (the plain
    versions stand in for the kernels on CPU tensors and count the same
    way), and the shares add up to the monolithic fn_exits."""
    _, _, x, model = setup
    s = model.summary()
    assert all(set(seg) == {'quant_matmul'}
               for seg in model.segment_launches)
    per_seg = [seg['quant_matmul'] for seg in model.segment_launches]
    assert sum(per_seg) == s['kernel_launches'] + s['exit_head_launches']
    h = torch.from_numpy(x)
    for k in range(model.n_stages):
        reset_counts()
        out = model.run_stage(k, h)
        assert counts()['quant_matmul']['plain_calls'] == per_seg[k]
        if k < model.n_stages - 1:
            h = out[1]
    reset_counts()
    model.fn_exits(model.params, torch.from_numpy(x))
    assert counts()['quant_matmul']['plain_calls'] == sum(per_seg)


def _oracle(model, x, threshold):
    xb = torch.cat([x[None], torch.zeros((SLOTS - 1,) + tuple(x.shape))])
    logits, exits = model.fn_exits(model.params, xb)
    stage, ans = exit_decisions(logits, exits, threshold)
    return int(stage[0]), ans[0]


def test_scheduler_bit_exact_vs_request_alone(setup):
    _, _, x, model = setup
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (20, HW, HW, 3)).astype(np.float32))
    threshold = calibrate_exit_threshold(model, xs[:SLOTS])
    t = np.cumsum(np.random.default_rng(6).exponential(1e-4, size=20))
    reqs = [Request(i, xs[i], float(t[i])) for i in range(20)]
    completions, metrics = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=threshold).run_trace(reqs)
    assert sorted(completions) == list(range(20))
    stages = {c.exit_stage for c in completions.values()}
    assert len(stages) > 1, 'the trace should exercise exits and survivors'
    for rid, c in completions.items():
        stage, ans = _oracle(model, xs[rid], threshold)
        assert c.exit_stage == stage
        np.testing.assert_array_equal(c.logits.view(np.int32),
                                      ans.view(np.int32))
    assert metrics.summary()['n_requests'] == 20


def test_scheduler_records_its_spans(setup):
    from repro_torch.obs.trace import Tracer
    _, _, x, model = setup
    xs = torch.from_numpy(x)
    tracer = Tracer()
    completions, metrics = ContinuousBatchScheduler(
        model, slots=SLOTS, threshold=2.0, tracer=tracer).run_trace(
            [Request(i, xs[i], 1e-4 * i) for i in range(SLOTS)])
    names = [s.name for s in tracer.spans]
    assert names.count('request.queue') == SLOTS
    assert names.count('stage.exec') == len(metrics.batches)
    assert names.count('compaction') == model.n_stages - 1
    events = tracer.to_chrome()['traceEvents']
    assert sum(e['ph'] == 'X' for e in events) == len(metrics.batches)
    p, cfg, _, _ = setup
    export_cnn(from_jax_params(p), cfg, device='cpu', calibrate=xs[:2],
               tracer=tracer)
    assert tracer.spans[-1].name == 'export.calibrate'


def test_scheduler_ages_out_at_its_own_horizon(setup):
    """A partial batch whose oldest request arrived at ``t`` must run once
    the clock reaches ``t + max_wait`` computed as that float sum (the
    horizon run_trace waits until).  At t = 0.2697867137638703,
    ``(t + 0.05) - t < 0.05``: a test written as a difference would never
    fire and the loop would wait at the same instant forever."""
    _, _, _, model = setup
    sched = ContinuousBatchScheduler(model, slots=SLOTS, max_wait=0.05)
    t = 0.2697867137638703
    assert (t + 0.05) - t < 0.05
    pend = [[(Request(0, None, t), None, None)]] + \
        [[] for _ in range(sched.n_segs - 1)]
    assert sched._pick(pend, more_arrivals=True, now=t + 0.05) == 0
    assert sched._pick(pend, more_arrivals=True, now=t + 0.04) is None


def test_scheduler_empty_trace_and_no_exit_heads(setup):
    _, cfg, x, model = setup
    completions, _ = ContinuousBatchScheduler(model, slots=SLOTS).run_trace(
        [])
    assert completions == {}
    p, _, _, _ = setup
    plain = {k: v for k, v in p.items() if k != 'exits'}
    bare = export_cnn(from_jax_params(plain), cfg.replace(exit_stages=()),
                      device='cpu', calibrate=torch.from_numpy(x[:2]))
    assert bare.fn_exits is None and bare.n_stages == 0
    with pytest.raises(ValueError):
        ContinuousBatchScheduler(bare, slots=SLOTS)


def test_export_refuses_unported_paths(setup):
    """An unknown selection mode is an error, and an export asked for the
    card raises without one.  Nothing of the CNN export is left to port:
    a model with a grouped conv of per-group depth > 1 exports and serves
    through the declared fp32 fallback at both tiers
    (``tests/test_torch_grouped_conv.py``).  (Measure mode is ported:
    ``tests/test_torch_obs.py``.)"""
    p, cfg, x, _ = setup
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match='select_kernels'):
        export_cnn(from_jax_params(p), cfg, device='cpu', calibrate=xt,
                   select_kernels='fastest')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            export_cnn(from_jax_params(p), cfg,
                       calibrate=torch.from_numpy(x))


# ----------------------------------------------------------- package rules


def _port_sources():
    srcs = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, files in os.walk(os.path.join(ROOT, 'src', 'repro_torch')):
        srcs += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return srcs


def test_port_names_no_jax_and_no_reference_package():
    bad = re.compile(r'^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)'
                     r'(\.|\s))', re.M)
    for path in _port_sources():
        with open(path) as f:
            hits = bad.findall(f.read())
        assert not hits, f'{path} imports {hits}'


def test_port_imports_without_jax():
    script = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(n == 'repro' or n.startswith('repro.') "
        "for n in sys.modules), 'the JAX package was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    r = subprocess.run([sys.executable, '-c', script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == 'ok', r.stderr


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.serve_cnn', '--server',
         '--config', 'resnet8-cifar', '--requests', '16', *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_serve_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    r = _serve_cli()
    assert r.returncode != 0
    assert 'no CUDA device' in r.stderr


def test_serve_cli_runs_on_the_cpu_when_asked():
    r = _serve_cli('--device', 'cpu', '--batch', '16', '--steps', '0')
    assert r.returncode == 0, r.stderr
    assert 'served 16 requests' in r.stdout
    assert 'quant_matmul=0 (plain' in r.stdout


def test_serve_cli_fine_tunes_before_export():
    r = _serve_cli('--device', 'cpu', '--batch', '16', '--steps', '2')
    assert r.returncode == 0, r.stderr
    assert 'QAT: 2 steps of 16 images, last loss' in r.stdout
    assert 'served 16 requests' in r.stdout
