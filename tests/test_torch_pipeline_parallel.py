"""Pipeline-parallel serving in the port (``serving/placement.py``'s
``PipelineParallelScheduler`` and ``pipeline_devices``,
``ServingModel.place_stages``, ``ModelRegistry.place``, ``serve_cnn
--pipeline``) against the JAX package.

* The reference's differential suite (``tests/test_pipeline_parallel.py``)
  on the port: resnet8, vgg8 and mobilenet-small (32 x 32 images, 8 slots,
  16 requests) served by the port's scheduler over 8 CPU ordinals
  (``devices=('cpu',) * 8``) in compacting, static and chaos modes (a kill
  at 0.4 of the compacting makespan); every completion's exit stage and
  logits bit-exact against the port's own ``fn_exits`` on the request
  alone at the slot geometry, a clean ``check_trace``, a clean
  ``placement-consistency`` on the placed model, the placement spread over
  more than one ordinal, a kill and a re-solve under chaos, and
  ``transfer.carry`` spans.
* Schedule parity: the reference's scheduler on 8 forced host devices
  (one subprocess) against the port's on 8 CPU ordinals, on resnet8 with
  the same weights (the port's init, handed over as numpy), images, costs
  and kill.  The exit threshold lies at least ``GAP`` from every exit
  confidence of either package (asserted).  The ``placement`` and
  ``kill`` events and the per-ordinal batch records (stage, live, slots,
  t, cost, ordinal) must be equal, and every exit stage where the
  request's stage-boundary int8 carries agree; the codes that differ are
  counted and printed, not asserted (ROADMAP's parity rule).  The same
  subprocess gives the reference's ``pipeline_devices`` on (4, 2) and
  (2, 2, 2) meshes, which the port's must match in count and order (its
  ``DeviceMesh`` built over the same device ids).
* ``ModelRegistry.place``; ``serve_cnn.main --pipeline --chaos`` in this
  process on fixed stage costs, where the one CPU device's kill is
  ``kill_skipped``; ``pipeline_devices()`` and the scheduler refuse to run
  without a card unless given ``devices=``.

About 35 s on one core: the reference's subprocess (its resnet8 export
with interpret-mode Pallas, 3 runs) about 25 s, the port's 9 runs 5 s.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest
from repro_torch.analysis import check as analyze
from repro_torch.configs.cnn import CNN_REGISTRY
from repro_torch.core.export import (calibrate_exit_threshold,
                                     exit_confidence, export_cnn)
from repro_torch.core.family import CNNFamily
from repro_torch.data import SyntheticImages
from repro_torch.interop import to_numpy
from repro_torch.obs import Tracer, check_trace
from repro_torch.serving import (ChaosPlan, ModelRegistry,
                                 PipelineParallelScheduler, Request,
                                 exit_decisions, pipeline_devices)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, N = 8, 16
KINDS = ('resnet8-cifar', 'vgg8-cifar', 'mobilenet-small-cifar')
MODES = (('compacting', True, False), ('static', False, False),
         ('chaos', True, True))
DEVICES = ('cpu',) * 8
GAP = 1e-3                       # threshold to every exit confidence


def _costs(n):
    """Synthetic per-stage costs: bit-exactness cannot depend on the
    simulated clock, only the batches executed on it are real."""
    return [1e-3 * (n - k) for k in range(n)]


def _build(kind, hw=32):
    """(export, numpy params, cfg, images, calibration batch) of one CNN
    kind: the port's seeded init, exit heads at the default points."""
    fam = CNNFamily(SyntheticImages(), device='cpu')
    cfg = CNN_REGISTRY[kind].replace(w_bits=8, a_bits=8)
    params = fam.init(torch.Generator().manual_seed(0), cfg)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                cfg.replace(exit_stages=()),
                                fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((N, hw, hw, 3)).astype(np.float32)
    calib = rng.standard_normal((SLOTS, hw, hw, 3)).astype(np.float32)
    model = export_cnn(params, cfg, device='cpu',
                       calibrate=torch.from_numpy(calib))
    return model, to_numpy(params), cfg, xs, calib


def _oracle(model, xs, thr):
    """Each request ALONE through the monolithic fn_exits at the slot
    geometry: {rid: (exit stage, answering logits)}."""
    out = {}
    for i, x in enumerate(torch.from_numpy(xs)):
        xb = torch.cat([x[None], torch.zeros((SLOTS - 1,) + tuple(x.shape))])
        logits, exits = model.fn_exits(model.params, xb)
        stage, ans = exit_decisions(logits, exits, thr)
        out[i] = (int(stage[0]), ans[0])
    return out


def _requests(xs):
    t = np.cumsum(np.full(len(xs), 2e-4))
    return [Request(i, torch.from_numpy(xs[i]), float(t[i]))
            for i in range(len(xs))]


def _runs(model, xs, thr, tracer=True):
    """{mode: (scheduler, completions, metrics, tracer)} over the three
    modes, the chaos kill at 0.4 of the compacting makespan."""
    costs, out, makespan = _costs(model.n_stages), {}, None
    for mode, compact, chaos in MODES:
        plan = (ChaosPlan(kills=((0.4 * makespan, None),)) if chaos
                else None)
        tr = Tracer() if tracer else None
        sch = PipelineParallelScheduler(
            model, slots=SLOTS, threshold=thr, stage_costs=costs,
            devices=DEVICES, compact=compact, chaos=plan, tracer=tr)
        comp, met = sch.run_trace(_requests(xs))
        out[mode] = (sch, comp, met, tr)
        if makespan is None:
            makespan = max(c.t_done for c in comp.values())
    return out


# ------------------------------------------------- the differential suite


@pytest.fixture(scope='module', params=KINDS)
def served(request):
    model, _, _, xs, calib = _build(request.param)
    thr = calibrate_exit_threshold(model, torch.from_numpy(calib))
    return (request.param, model, calib, _oracle(model, xs, thr),
            _runs(model, xs, thr))


@pytest.mark.parametrize('mode', [m for m, _, _ in MODES])
def test_pipeline_bit_exact_on_8_ordinals(served, mode):
    kind, model, calib, oracle, runs = served
    sch, comp, met, tr = runs[mode]
    assert len(comp) == N, (kind, mode, len(comp))
    for rid, (stage, ans) in oracle.items():
        c = comp[rid]
        assert c.exit_stage == stage, (kind, mode, rid)
        np.testing.assert_array_equal(c.logits.view(np.int32),
                                      ans.view(np.int32))
    assert len(set(sch.stage_dev)) > 1, (kind, 'placement collapsed')
    assert check_trace(tr, comp) == []
    rep = analyze(model=sch.model, x=torch.from_numpy(calib),
                  rules=('placement-consistency',), target=f'{kind}:{mode}')
    assert 'placement-consistency' in rep.checked and rep.ok, str(rep)
    assert any(s.name == 'transfer.carry' for s in tr.spans), \
        (kind, mode, 'no cross-ordinal carry transfer')
    kinds = [e[0] for e in met.events]
    if mode == 'chaos':
        assert 'kill' in kinds, (kind, 'no kill fired')
        assert kinds.count('placement') >= 2, (kind, 'no re-solve')
        assert len(sch.alive) == len(DEVICES) - 1
    else:
        assert kinds == ['placement']
    # each ordinal's flights never overlap on the simulated clock
    by_dev = {}
    for t, cost, dev in met.device_samples:
        by_dev.setdefault(dev, []).append((t, t + cost))
    for spans in by_dev.values():
        spans.sort()
        assert all(a[1] <= b[0] + 1e-12 for a, b in zip(spans, spans[1:]))


# ------------------------------------------------------ schedule parity

PARITY_SCRIPT = r'''
import pickle
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 8
from repro.configs.cnn import RESNET8_CIFAR
from repro.core.export import export_cnn, exit_confidence
from repro.launch.mesh import data_axes
from repro.serving import (PipelineParallelScheduler, Request,
                           pipeline_devices)
from repro.serving.replica import ChaosPlan
with open(IN_PATH, 'rb') as f:
    inp = pickle.load(f)
cfg = RESNET8_CIFAR.replace(exit_stages=tuple(inp['exit_stages']),
                            w_bits=8, a_bits=8)
model = export_cnn(inp['params'], cfg, use_pallas=True,
                   calibrate=inp['calib'])
xs, slots = inp['xs'], inp['slots']
conf, carries = [], []
for i in range(0, len(xs), slots):
    h = jnp.asarray(xs[i:i + slots])
    for k in range(model.n_stages - 1):
        exits, h = model.run_stage(k, h)
        carries.append(np.asarray(h.q))
        for s in exits:
            conf.append(np.asarray(exit_confidence(exits[s])))
conf = np.concatenate(conf)
allc = np.sort(np.concatenate([conf, inp['port_conf']]))
lo, hi = 15 * len(allc) // 100, 85 * len(allc) // 100
j = lo + int(np.argmax(np.diff(allc[lo:hi + 1])))
thr = float((allc[j] + allc[j + 1]) / 2)
costs = [1e-3 * (model.n_stages - k) for k in range(model.n_stages)]
runs, makespan = {}, None
for mode, compact, chaos in inp['modes']:
    plan = ChaosPlan(kills=((0.4 * makespan, None),)) if chaos else None
    reqs = [Request(i, jnp.asarray(xs[i]), float(inp['t'][i]))
            for i in range(len(xs))]
    sch = PipelineParallelScheduler(model, slots=slots, threshold=thr,
                                    stage_costs=costs, compact=compact,
                                    chaos=plan)
    comp, met = sch.run_trace(reqs)
    runs[mode] = {'events': met.events,
                  'batch_samples': met.batch_samples,
                  'device_samples': met.device_samples,
                  'stages': {r: c.exit_stage for r, c in comp.items()},
                  't_done': {r: c.t_done for r, c in comp.items()},
                  'stage_dev': sch.stage_dev}
    if makespan is None:
        makespan = max(c.t_done for c in comp.values())
meshes = {}
for shape, axes in (((4, 2), ('data', 'model')),
                    ((2, 2, 2), ('pod', 'data', 'model'))):
    mesh = jax.make_mesh(shape, axes)
    meshes[shape] = {'ids': np.vectorize(lambda d: d.id)(mesh.devices),
                     'pipeline': [d.id for d in pipeline_devices(mesh)],
                     'data_axes': data_axes(mesh)}
with open(OUT_PATH, 'wb') as f:
    pickle.dump({'conf': conf, 'carries': carries, 'thr': thr,
                 'runs': runs, 'meshes': meshes}, f)
'''


def _port_conf_and_carries(model, xs):
    conf, carries = [], []
    for i in range(0, len(xs), SLOTS):
        h = torch.from_numpy(xs[i:i + SLOTS])
        for k in range(model.n_stages - 1):
            exits, h = model.run_stage(k, h)
            carries.append(h.q.numpy())
            for s in exits:
                conf.append(exit_confidence(exits[s]).numpy())
    return np.concatenate(conf), carries


@pytest.fixture(scope='module')
def parity(tmp_path_factory):
    d = tmp_path_factory.mktemp('pipeline_parity')
    model, params, cfg, xs, calib = _build('resnet8-cifar', hw=16)
    conf, carries = _port_conf_and_carries(model, xs)
    t = np.cumsum(np.full(N, 2e-4))
    with open(d / 'in.pkl', 'wb') as f:
        pickle.dump({'params': params, 'calib': calib, 'xs': xs, 't': t,
                     'slots': SLOTS, 'exit_stages': cfg.exit_stages,
                     'modes': MODES, 'port_conf': conf}, f)
    r = subprocess.run(
        [sys.executable, '-c', PARITY_SCRIPT.replace(
            'IN_PATH', repr(str(d / 'in.pkl'))).replace(
            'OUT_PATH', repr(str(d / 'out.pkl')))],
        env=conftest.forced_device_env(8), capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert r.returncode == 0, f'stdout={r.stdout}\nstderr={r.stderr[-4000:]}'
    with open(d / 'out.pkl', 'rb') as f:
        ref = pickle.load(f)
    return {'model': model, 'xs': xs, 'conf': conf, 'carries': carries,
            'ref': ref, 'runs': _runs(model, xs, ref['thr'], tracer=False)}


def test_parity_threshold_sits_on_no_tie(parity):
    allc = np.concatenate([parity['conf'], parity['ref']['conf']])
    gap = float(np.min(np.abs(allc - parity['ref']['thr'])))
    assert gap >= GAP, gap
    assert (allc > parity['ref']['thr']).any()
    assert (allc < parity['ref']['thr']).any()


@pytest.mark.parametrize('mode', [m for m, _, _ in MODES])
def test_schedule_matches_reference_event_for_event(parity, mode):
    want = parity['ref']['runs'][mode]
    sch, comp, met, _ = parity['runs'][mode]
    assert sch.stage_dev == tuple(want['stage_dev'])
    assert met.events == want['events']
    assert met.batch_samples == want['batch_samples']
    assert met.device_samples == want['device_samples']
    # exit stages wherever the request's stage-boundary carries agree
    n_seg = parity['model'].n_stages - 1
    differ, agree = 0, []
    for b, (got, ref) in enumerate(zip(parity['carries'],
                                       parity['ref']['carries'])):
        diff = got != ref
        differ += int(diff.sum())
        rows = ~diff.reshape(diff.shape[0], -1).any(1)
        agree.append(rows)
    print(f'{mode}: {differ} int8 carry codes of '
          f'{sum(c.size for c in parity["carries"])} differ')
    for rid in range(N):
        batch, row = divmod(rid, SLOTS)
        if all(agree[batch * n_seg + k][row] for k in range(n_seg)):
            assert comp[rid].exit_stage == want['stages'][rid], rid
            assert comp[rid].t_done == want['t_done'][rid], rid
    if mode == 'chaos':
        assert [e[0] for e in met.events].count('kill') == 1


def _device_mesh(ids, axes):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh('cpu', torch.as_tensor(ids), mesh_dim_names=axes,
                      _init_backend=False, _rank=0)


@pytest.mark.parametrize('shape', ((4, 2), (2, 2, 2)))
def test_pipeline_devices_on_meshes_match_reference(parity, shape):
    """The model-index-0 slice over the data axes: the reference's count
    and order of device ids on the same layout; one CPU device a rank."""
    from repro_torch.launch.mesh import data_axes
    from repro_torch.serving.placement import pipeline_ranks
    ref = parity['ref']['meshes'][shape]
    axes = ('data', 'model') if len(shape) == 2 else ('pod', 'data',
                                                      'model')
    mesh = _device_mesh(ref['ids'], axes)
    assert data_axes(mesh) == ref['data_axes']
    assert list(pipeline_ranks(mesh)) == ref['pipeline']
    assert len(ref['pipeline']) == 4
    assert pipeline_devices(mesh) == (torch.device('cpu'),) * 4


def test_pipeline_devices_local_mesh():
    mesh = _device_mesh([[0]], ('data', 'model'))
    assert pipeline_devices(mesh) == (torch.device('cpu'),)


@pytest.mark.skipif(torch.cuda.is_available(), reason='asserts no card')
def test_pipeline_devices_needs_a_card_unless_given_devices():
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pipeline_devices()
    model, _, _, _, _ = _build('resnet8-cifar', hw=16)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        PipelineParallelScheduler(model, slots=SLOTS, stage_costs=_costs(3))
    sch = PipelineParallelScheduler(model, slots=SLOTS,
                                    stage_costs=_costs(3), devices=('cpu',))
    assert sch.devices == (torch.device('cpu'),)
    assert sch.model.stage_devices == (torch.device('cpu'),) * 3


# ------------------------------------------------- registry and the CLI


def test_registry_place_commits_stage_devices():
    from repro_torch.analysis.mutations import _resnet_export
    model, _, _, x = _resnet_export(exits=True)
    reg = ModelRegistry()
    reg.register('cnn', model)
    p = reg.plan_placement(2, {'cnn': [3.0, 2.0, 1.0]})
    placed = reg.place('cnn', p, DEVICES[:2])
    assert placed.stage_devices == (torch.device('cpu'),) * model.n_stages
    assert placed.stage_params is not None
    assert placed.stage_params[0] is placed.stage_params[1]  # one device
    assert reg.get('cnn') is placed          # registry entry re-pointed
    a, b = placed.serve_stages(x), model.serve_stages(x)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match='one device per stage'):
        model.place_stages(('cpu',))


def test_serve_cli_pipeline_chaos_kill_skipped_on_one_device(
        tmp_path, monkeypatch, capsys):
    """``--pipeline --chaos`` on the one CPU device: the placement line,
    every request served, and the seeded kill recorded as ``kill_skipped``
    (the last device is never killed).  The stage costs are fixed (the
    card's resnet34-cifar costs at 32 slots), so the kill's time does not
    move with this host's load."""
    from repro_torch.launch import serve_cnn
    from repro_torch.obs import load_chrome_trace
    monkeypatch.setattr(serve_cnn, '_measure_stage_costs',
                        lambda model, x, iters=5: [6.05e-3, 5.29e-3,
                                                   3.81e-3])
    out = str(tmp_path / 'trace.json')
    comp, met = serve_cnn.main([
        '--pipeline', '--chaos', '--config', 'resnet8-cifar', '--device',
        'cpu', '--steps', '0', '--batch', '16', '--slots', '8',
        '--requests', '32', '--rate', '500', '--trace', out])
    stdout = capsys.readouterr().out
    assert 'placement over 1 devices' in stdout
    assert 'served 32 requests' in stdout and 'clock=simulated' in stdout
    assert len(comp) == 32
    skipped = [e for e in met.events if e[0] == 'kill_skipped']
    assert skipped and skipped[0][2]['reason'] == 'last device'
    assert not [e for e in met.events if e[0] == 'kill']
    assert check_trace(load_chrome_trace(out)) == []
    with pytest.raises(SystemExit):
        serve_cnn.main(['--pipeline', '--deadline-ms', '5', '--device',
                        'cpu'])
