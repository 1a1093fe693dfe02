"""The serving runtime's other half in the PyTorch port, held against the
JAX package: the SLO layer (admission, urgency, degradation through the
exit heads), the replica pool under seeded chaos (kills, stragglers,
elastic scaling, checkpoint-backed failover through ``ModelRegistry``),
the static full-depth baseline, the metrics' SLO and resilience blocks,
and the placement solver (``serve_cnn``'s runtime flags run in
``test_torch_obs.py``, beside the trace they write).

Both packages serve resnet8 with exit heads, built once per module from
the same numpy weights and calibration batch (8 slots, 16 x 16 images;
the requests cycle over a pool of 16 images):
the reference through ``export_cnn(use_pallas=True, calibrate=x)`` (its
int8 kernels in interpret mode, the arithmetic the port's plain versions
follow), the port through its own on the CPU.  On the same simulated costs and the
same Poisson trace the two runs must agree exactly: every completion's
``exit_stage``, ``t_start``, ``t_done``, ``pred`` and ``degraded``, the
rejections, the resilience events, the whole metrics summary and, where
traced, every span.  The
two exports' logits differ in their last bits, so the exit threshold is
chosen at least ``GAP`` away from every request's exit confidence in both
packages (asserted), and no exit decision sits on a tie.  Within the
port, every completion is bit-exact against its own ``fn_exits`` on the
request alone at the slot geometry, through a chaos kill too.

About 45 s on one CPU worker, 30 s of it the two exports.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import save_chain_state as j_save_chain_state
from repro.configs.cnn import RESNET8_CIFAR as J_RESNET8
from repro.core.export import exit_confidence as j_exit_confidence
from repro.core.export import export_cnn as j_export_cnn
from repro.core.family import CNNFamily as JFamily
from repro.core.passes import ChainState as JChainState
from repro.data import SyntheticImages as JImages
from repro.obs import Tracer as JTracer
from repro.obs import check_trace as j_check_trace
from repro.runtime.straggler import StragglerMonitor as JMonitor
from repro import serving as J
from repro.serving.placement import solve_placement as j_solve_placement
from repro_torch import serving as T
from repro_torch.checkpoint import save_chain_state
from repro_torch.configs.cnn import RESNET8_CIFAR
from repro_torch.core.export import exit_confidence, export_cnn
from repro_torch.core.family import CNNFamily
from repro_torch.core.passes import ChainState
from repro_torch.data import SyntheticImages
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.obs import Tracer as TTracer
from repro_torch.obs import check_trace
from repro_torch.runtime import StragglerMonitor
from repro_torch.serving.placement import DEFAULT_MODEL, lpt_ratio

torch.set_num_threads(1)

SLOTS = 8
HW = 16
COSTS = [4e-3, 2e-3, 1e-3]                # simulated per-segment batch costs
POOL = 2 * SLOTS                          # distinct request images
GAP = 1e-3                                # threshold to every confidence


@pytest.fixture(scope='module')
def setup():
    """(reference export, port export, numpy params, reference and port
    cfg, calibration batch, request images, threshold).  The weights are
    the port's resnet8 init (seeds 0 and 2), handed to the reference as
    numpy."""
    fam = CNNFamily(SyntheticImages(), device='cpu')
    tp = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    tp, tcfg = fam.add_exits(torch.Generator().manual_seed(2), tp,
                             RESNET8_CIFAR,
                             fam.default_exit_points(RESNET8_CIFAR))
    tcfg = tcfg.replace(w_bits=8, a_bits=8)
    cfg = J_RESNET8.replace(exit_stages=tcfg.exit_stages, w_bits=8,
                            a_bits=8)
    p = to_numpy(tp)
    rng = np.random.default_rng(3)
    calib = rng.standard_normal((SLOTS, HW, HW, 3)).astype(np.float32)
    xs = rng.standard_normal((POOL, HW, HW, 3)).astype(np.float32)
    ref = j_export_cnn(p, cfg, use_pallas=True, calibrate=calib)
    port = export_cnn(from_jax_params(p), tcfg, device='cpu',
                      calibrate=torch.from_numpy(calib))
    return dict(ref=ref, port=port, params=p, cfg=cfg, tcfg=tcfg,
                calib=calib, xs=xs, thr=_threshold(ref, port, xs))


def _confidences(ref, port, xs):
    """Every request's exit confidence at every head, in each package, at
    the slot geometry (slots are independent, so a batch of SLOTS
    requests gives each one's answer), through the stage segments the
    schedulers run."""
    out = []
    for i in range(0, len(xs), SLOTS):
        xb = xs[i:i + SLOTS]
        _, je = ref.serve_stages(xb)
        _, te = port.serve_stages(torch.from_numpy(xb))
        for s in je:
            out.append(np.asarray(j_exit_confidence(je[s])))
            out.append(exit_confidence(te[s]).numpy())
    return np.concatenate(out)


def _threshold(ref, port, xs):
    """The midpoint of the widest gap between exit confidences in their
    central 70%, so that some requests exit and some survive."""
    conf = np.sort(_confidences(ref, port, xs))
    lo, hi = 15 * len(conf) // 100, 85 * len(conf) // 100
    i = lo + int(np.argmax(np.diff(conf[lo:hi + 1])))
    return float((conf[i] + conf[i + 1]) / 2)


def test_threshold_sits_on_no_tie(setup):
    conf = _confidences(setup['ref'], setup['port'], setup['xs'])
    gap = float(np.min(np.abs(conf - setup['thr'])))
    assert gap >= GAP, f'threshold {setup["thr"]} only {gap:.2e} from a ' \
        'confidence'
    assert (conf > setup['thr']).any() and (conf < setup['thr']).any()


def _trace(setup, n, rate=2000.0, seed=0, budgets=None):
    """The same arrival trace for both packages: (reference requests, port
    requests), fresh objects (the schedulers write their times).  Request
    ``i`` carries image ``i % POOL``."""
    t = np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n))
    dl = [None if budgets is None else float(t[i] + budgets[i])
          for i in range(n)]
    xs = setup['xs']
    return ([J.Request(i, jnp.asarray(xs[i % POOL]), float(t[i]),
                       deadline=dl[i]) for i in range(n)],
            [T.Request(i, torch.from_numpy(xs[i % POOL]), float(t[i]),
                       deadline=dl[i]) for i in range(n)])


def _same_run(got, want):
    """The port's run equals the reference's: completions, rejections,
    resilience events and the whole metrics summary."""
    (tc, tm), (jc, jm) = got, want
    assert sorted(tc) == sorted(jc)
    for rid, w in jc.items():
        g = tc[rid]
        assert (g.exit_stage, g.t_arrival, g.t_start, g.t_done, g.pred,
                g.deadline, g.degraded) == \
            (w.exit_stage, w.t_arrival, w.t_start, w.t_done, w.pred,
             w.deadline, w.degraded), rid
    assert tm.rejections == jm.rejections
    assert tm.events == jm.events
    assert tm.batches == jm.batches
    assert tm.summary() == jm.summary()


def _oracle(model, x, threshold):
    """The port's monolithic fn_exits on the request ALONE at the slot
    geometry: (exit stage, answering logits, the exit heads' rows)."""
    xb = torch.cat([x[None], torch.zeros((SLOTS - 1,) + tuple(x.shape))])
    logits, exits = model.fn_exits(model.params, xb)
    stage, ans = T.exit_decisions(logits, exits, threshold)
    return int(stage[0]), ans[0], {s: v[0].numpy() for s, v in exits.items()}


def _bit_exact(model, reqs, comp, threshold):
    """Every non-degraded completion equals the request-alone oracle bit for
    bit; a degraded one its stored exit head's row."""
    for r in reqs:
        if r.rid not in comp:
            continue
        c = comp[r.rid]
        stage, ans, heads = _oracle(model, r.x, threshold)
        want = heads[c.exit_stage] if c.degraded else ans
        if not c.degraded:
            assert c.exit_stage == stage, r.rid
        np.testing.assert_array_equal(c.logits.view(np.int32),
                                      want.view(np.int32))


def _spans(tracer):
    return [(s.name, s.t0, s.t1, s.track, s.kind, s.cid, s.args)
            for s in tracer.spans]


def _both(setup, make, reqs_pair, traced=False):
    """Run ``make(package, model, tracer)``'s scheduler on each package's
    copy of the trace: ((port completions, metrics), (reference ...)).
    ``traced``: both runs record a trace, and the port's spans must equal
    the reference's and pass both packages' ``check_trace``."""
    jr, tr = reqs_pair
    tt, jt = (TTracer(), JTracer()) if traced else (None, None)
    got = make(T, setup['port'], tt).run_trace(tr)
    want = make(J, setup['ref'], jt).run_trace(jr)
    if traced:
        assert _spans(tt) == _spans(jt)
        assert check_trace(tt, got[0], strict=True) == []
        assert j_check_trace(list(tt.spans), got[0]) == []
    return got, want


# ------------------------------------------------------------- SLO policy


def _slo_decisions(pkg):
    slo = pkg.SLOPolicy()
    out = [slo.admit(deadline=0.0, now=0.0, backlog=99, slots=8)]
    slo.seed(COSTS)
    out += [slo.max_cost,
            slo.admit(now=0.0, deadline=8e-3, backlog=0, slots=8),
            slo.admit(now=0.0, deadline=7.9e-3, backlog=0, slots=8),
            slo.admit(now=0.0, deadline=10e-3, backlog=8, slots=8),
            slo.admit(now=0.0, deadline=12e-3, backlog=8, slots=8),
            slo.admit_explain(9e-3, 1e-3, 3, 8),
            slo.latest_start(1, deadline=10e-3),
            slo.affordable(5e-3, now=1e-3, k=1, charge=4e-3, in_batch=True),
            slo.affordable(5e-3, now=1e-3, k=1, charge=4e-3,
                           in_batch=False)]
    slo2 = pkg.SLOPolicy(slack=2.0)
    slo2.seed(COSTS)
    slo3 = pkg.SLOPolicy(stage_costs=[None, None])
    slo3.observe(0, 4e-3)
    a = slo3._cost(0)
    slo3.observe(0, 8e-3)
    Req = pkg.Request
    pend = [[(Req(0, None, 0.0, deadline=9e-3),)],
            [(Req(1, None, 0.0, deadline=6e-3),), (Req(2, None, 0.0),)]]
    return out + [slo2._cost(0), a, slo3._cost(0),
                  slo.urgent_segment(pend, 0.0),
                  slo.urgent_segment(pend, -5e-3), slo.wake(pend, 0.0),
                  slo.wake([[], []], 0.0)]


def test_slo_policy_decisions_match_reference():
    got, want = _slo_decisions(T), _slo_decisions(J)
    assert got == want
    assert got[0] and got[1] == 4e-3 and got[2] and not got[3]
    assert not got[4] and got[5] and got[8] and not got[9]
    assert 4e-3 < got[-5] < 8e-3                  # the EWMA blend


def test_slo_wake_horizon_is_urgent():
    """Woken at :meth:`SLOPolicy.wake`'s horizon, the scheduler finds a
    segment urgent: were the two tests to round apart, it would sleep
    until the same horizon again and never advance its clock.  Random
    costs, arrival times and deadlines; about 1.5% of them round apart
    when the urgency test is written ``ls <= now + max_cost``."""
    rng = np.random.default_rng(0)
    n = 0
    for _ in range(20000):
        slo = T.SLOPolicy()
        slo.seed(list(rng.uniform(3e-3, 9e-3, 3)))
        now = float(rng.uniform(0.0, 0.2))
        j = int(rng.integers(0, 3))
        pend = [[] for _ in range(3)]
        pend[j].append((T.Request(0, None, now, deadline=now + float(
            rng.uniform(12e-3, 80e-3))),))
        wake = slo.wake(pend, now)
        if wake > now:
            n += 1
            assert slo.urgent_segment(pend, wake) == j
    assert n > 19000


def test_request_queue_requeue_fifo():
    for pkg in (T, J):
        q = pkg.RequestQueue([pkg.Request(i, None, float(i))
                              for i in range(4)])
        got = q.pop_ready(10.0, 2)
        assert [r.rid for r in got] == [0, 1]
        q.requeue(got[1])
        assert [r.rid for r in q.pop_ready(10.0, 3)] == [1, 2, 3]
        q.push(pkg.Request(9, None, 9.0))
        with pytest.raises(ValueError, match='requeue'):
            q.push(pkg.Request(10, None, 1.0))
        q.requeue(pkg.Request(10, None, 1.0))
        assert [r.rid for r in q.pop_ready(10.0, 2)] == [10, 9]
    c = T.Completion(0, None, 0, -1, 0.0, 2.0, deadline=2.0)
    assert c.on_time and T.Completion(0, None, 0, -1, 0.0, 2.0).on_time \
        is None
    assert not T.Completion(0, None, 0, -1, 0.0, 2.1, deadline=2.0).on_time


# ------------------------------------------ SLO on the single scheduler


def _continuous(threshold, slo=False, **kw):
    def make(pkg, model, tracer=None):
        return pkg.ContinuousBatchScheduler(
            model, slots=SLOTS, threshold=threshold, stage_costs=COSTS,
            slo=pkg.SLOPolicy() if slo else None, tracer=tracer, **kw)
    return make


def test_slo_rejects_hopeless_admission(setup):
    (tc, tm), want = _both(setup, _continuous(setup['thr'], slo=True),
                           _trace(setup, SLOTS, budgets=[1e-3] * SLOTS))
    _same_run((tc, tm), want)
    assert tc == {}
    s = tm.summary()
    assert s['n_rejected'] == SLOTS and s['availability'] == 0.0
    assert s['slo'] == {'n_with_deadline': SLOTS, 'n_on_time': 0,
                        'n_late': 0, 'attainment': 0.0}
    assert all(reason == 'admission' for _, _, reason in tm.rejections)


def test_slo_degrades_to_exit_head_never_late(setup):
    """Threshold 2.0: nobody exits by choice.  A burst of 3 batches with
    one shared budget: the first affords full depth, a later one degrades
    at an exit head on time, the tail is rejected.  Same decisions as the
    reference; every degraded answer is its head's own row."""
    n = 3 * SLOTS
    budget = 2 * COSTS[0] + COSTS[1] + COSTS[2] + 2e-3
    pair = _trace(setup, n, rate=50000.0, budgets=[budget] * n)
    (tc, tm), want = _both(setup, _continuous(2.0, slo=True), pair,
                           traced=True)
    _same_run((tc, tm), want)
    s = tm.summary()
    assert len(tc) + s['n_rejected'] == n
    assert s['n_degraded'] >= 1 and s['n_rejected'] >= 1
    assert s['slo']['n_late'] == 0
    assert sum(s['degraded_exit_mix'].values()) == s['n_degraded']
    assert all(c.on_time for c in tc.values())
    assert all(c.exit_stage >= 0 for c in tc.values() if c.degraded)
    _bit_exact(setup['port'], pair[1], tc, 2.0)


def test_slo_never_late_random_budgets(setup):
    n = 4 * SLOTS
    budgets = np.random.default_rng(42).uniform(0.3, 3.0, n) * sum(COSTS)
    pair = _trace(setup, n, rate=1500.0, budgets=budgets)
    (tc, tm), want = _both(setup, _continuous(setup['thr'], slo=True), pair)
    _same_run((tc, tm), want)
    s = tm.summary()
    assert len(tc) + s['n_rejected'] == n
    assert s['slo']['n_late'] == 0 and s['slo']['n_on_time'] == len(tc)
    _bit_exact(setup['port'], pair[1], tc, setup['thr'])


def test_continuous_scheduler_matches_reference(setup):
    """No SLO: the compacting scheduler's run on the simulated clock equals
    the reference's.  (With ``max_wait`` the reference can wait forever at
    its own aging horizon, which the port's ``_pick`` repairs:
    ``test_torch_serving.py::test_scheduler_ages_out_at_its_own_horizon``.)
    """
    pair = _trace(setup, 3 * SLOTS + 5)
    (tc, tm), want = _both(setup, _continuous(setup['thr']), pair,
                           traced=True)
    _same_run((tc, tm), want)
    assert {c.exit_stage for c in tc.values()} > {-1}
    _bit_exact(setup['port'], pair[1], tc, setup['thr'])


def test_static_scheduler_matches_reference_and_compacting(setup):
    pair = _trace(setup, 2 * SLOTS + 3)

    def static(pkg, model, tracer=None):
        return pkg.StaticBatchScheduler(model, slots=SLOTS,
                                        threshold=setup['thr'],
                                        batch_cost=sum(COSTS),
                                        tracer=tracer)
    (sc, sm), want = _both(setup, static, pair, traced=True)
    _same_run((sc, sm), want)
    cc, _ = _continuous(setup['thr'])(T, setup['port']).run_trace(
        _trace(setup, 2 * SLOTS + 3)[1])
    for rid, c in cc.items():
        assert sc[rid].exit_stage == c.exit_stage
        np.testing.assert_array_equal(sc[rid].logits, c.logits)
    for c in sc.values():
        assert c.queue_wait + c.execute == pytest.approx(c.latency)
        assert c.execute == pytest.approx(sum(COSTS))
    with pytest.raises(ValueError, match='exit heads'):
        T.StaticBatchScheduler(export_cnn(
            from_jax_params({k: v for k, v in setup['params'].items()
                             if k != 'exits'}),
            setup['tcfg'].replace(exit_stages=()), device='cpu'))


def test_wall_clock_slo_learns_costs_online(setup):
    """stage_costs=None: the clock is the wall time of each synchronized
    batch, and the SLO policy learns its costs from them."""
    slo = T.SLOPolicy()
    sched = T.ContinuousBatchScheduler(setup['port'], slots=SLOTS,
                                       threshold=2.0, slo=slo)
    assert slo.stage_costs == [None] * setup['port'].n_stages
    comp, met = sched.run_trace(_trace(setup, SLOTS, budgets=[10.0] * SLOTS)
                                [1])
    assert len(comp) == SLOTS and all(c.t_done > c.t_arrival
                                      for c in comp.values())
    assert all(c is not None and c > 0 for c in slo.stage_costs)
    with pytest.raises(ValueError, match='stage_costs'):
        T.ContinuousBatchScheduler(setup['port'], stage_costs=[1.0])


# ------------------------------------------------------- replica pool


def _pool(threshold, **kw):
    def make(pkg, model, tracer=None):
        kws = dict(kw)
        if kws.pop('slo', False):
            kws['slo'] = pkg.SLOPolicy()
        if 'chaos' in kws:
            kws['chaos'] = pkg.ChaosPlan(**kws['chaos'])
        return pkg.ReplicaPoolScheduler(model, slots=SLOTS,
                                        threshold=threshold,
                                        stage_costs=COSTS, tracer=tracer,
                                        **kws)
    return make


@pytest.mark.parametrize('seed,n,horizon', [(0, 2, 0.05), (1, 3, 0.2),
                                            (7, 2, 1.5)])
def test_chaos_plan_seeded_matches_reference(seed, n, horizon):
    got = T.ChaosPlan.seeded(seed, n, horizon, n_kills=2, n_slowdowns=2)
    want = J.ChaosPlan.seeded(seed, n, horizon, n_kills=2, n_slowdowns=2)
    assert got.kills == want.kills and got.slowdowns == want.slowdowns
    for rid in range(n):
        for t in (0.0, horizon / 2, horizon):
            assert got.slow_factor(rid, t) == want.slow_factor(rid, t)


def test_straggler_monitor_matches_reference():
    ratios = [1.0, 1.0, 2.6, 2.6, 1.0, 3.0, 3.0, 3.0, 0.9]
    for evict in (2, 10 ** 9):
        a = StragglerMonitor(n_hosts=1, threshold=1.5, evict_after=evict)
        b = JMonitor(n_hosts=1, threshold=1.5, evict_after=evict)
        for i, r in enumerate(ratios):
            assert a.observe_one(i % 3, r) == b.observe_one(i % 3, r)
            assert a.ewma == b.ewma and a.flags == b.flags
    a, b = StragglerMonitor(n_hosts=2, spares=[7]), \
        JMonitor(n_hosts=2, spares=[7])
    for times in ({0: 1.0, 1: 1.0}, {0: 1.0, 1: 5.0}, {0: 1.0, 1: 5.0}):
        assert a.observe(times) == b.observe(times)
    assert a.host_map == b.host_map and a.data_host_id(1) == 7


def test_pool_requires_stage_costs(setup):
    with pytest.raises(ValueError, match='stage_costs'):
        T.ReplicaPoolScheduler(setup['port'], slots=SLOTS)
    with pytest.raises(ValueError, match='min_replicas'):
        T.ReplicaPoolScheduler(setup['port'], slots=SLOTS,
                               stage_costs=COSTS, min_replicas=0)


def test_pool_matches_single_executor_and_reference(setup):
    pair = _trace(setup, 3 * SLOTS + 3)
    got, want = _both(setup, _pool(setup['thr'], replicas=3,
                                   min_replicas=3), pair)
    _same_run(got, want)
    single, _ = _continuous(setup['thr'])(T, setup['port']).run_trace(
        _trace(setup, 3 * SLOTS + 3)[1])
    for rid, c in got[0].items():
        assert c.exit_stage == single[rid].exit_stage
        np.testing.assert_array_equal(c.logits, single[rid].logits)


def _chain_dirs(setup, tmp_path):
    """The same float params persisted as a chain checkpoint by each
    package; their registries load the int8-resident model from it."""
    cfg, p, thr = setup['cfg'], setup['params'], setup['thr']
    jdir, tdir = str(tmp_path / 'ref'), str(tmp_path / 'port')
    jfam = JFamily(JImages())
    j_save_chain_state(jdir, JChainState(family=jfam, cfg=cfg, params=p,
                                         key=jax.random.key(7),
                                         exit_threshold=thr), step=0)
    tfam = CNNFamily(SyntheticImages(), device='cpu')
    save_chain_state(tdir, ChainState(family=tfam, cfg=setup['tcfg'],
                                      params=from_jax_params(p), key=7,
                                      exit_threshold=thr), step=0)
    jreg, treg = J.ModelRegistry(), T.ModelRegistry()
    jm = jreg.load('m', jdir, jfam, use_pallas=True,
                   calibrate=setup['calib'])
    tm = treg.load('m', tdir, tfam, device='cpu',
                   calibrate=torch.from_numpy(setup['calib']))
    return (treg, tm), (jreg, jm)


def test_pool_chaos_kill_requeues_and_restores(setup, tmp_path):
    """A replica killed mid-batch loses nothing: its in-flight requests
    requeue, a replacement restores from the chain checkpoint through the
    registry, and every completion stays bit-exact against the port's own
    request-alone oracle; the run equals the reference's."""
    (treg, tmodel), (jreg, jmodel) = _chain_dirs(setup, tmp_path)
    assert tmodel.exit_threshold == setup['thr']
    restores = []

    def restore(reg):
        def f():
            restores.append(1)
            return reg.restore('m')
        return f

    kw = dict(slots=SLOTS, threshold=setup['thr'], stage_costs=COSTS,
              replicas=2, min_replicas=2, restore_delay=COSTS[0])
    jr, tr = _trace(setup, 3 * SLOTS, rate=4000.0)
    tt, jt = TTracer(), JTracer()
    got = T.ReplicaPoolScheduler(
        tmodel, chaos=T.ChaosPlan(kills=((4e-3, 0),)), restore=restore(treg),
        tracer=tt, **kw).run_trace(tr)
    want = J.ReplicaPoolScheduler(
        jmodel, chaos=J.ChaosPlan(kills=((4e-3, 0),)), restore=restore(jreg),
        tracer=jt, **kw).run_trace(jr)
    _same_run(got, want)
    assert _spans(tt) == _spans(jt)
    assert {'kill', 'failover.restore'} <= {s.name for s in tt.spans}
    assert check_trace(tt, got[0], strict=True) == []
    comp, met = got
    assert len(comp) == len(tr)
    kills = [i for k, _, i in met.events if k == 'kill']
    assert kills and kills[0]['mid_batch']
    assert met.summary()['resilience']['failovers'] == 1
    assert restores == [1, 1]
    assert treg.get('m') is not tmodel
    _bit_exact(tmodel, tr, comp, setup['thr'])
    x = torch.from_numpy(setup['xs'][:SLOTS])
    for a, b in zip(tmodel.serve_stages(x)[1].values(),
                    treg.get('m').serve_stages(x)[1].values()):
        assert torch.equal(a, b)


def test_pool_straggler_flagged_and_evicted(setup):
    kw = dict(replicas=2, min_replicas=2, max_replicas=2)
    pair = _trace(setup, 6 * SLOTS, rate=50000.0)
    got, want = _both(setup, _pool(setup['thr'], evict_after=2,
                                   chaos=dict(slowdowns=((0.0, 0, 2.5),)),
                                   **kw), pair, traced=True)
    _same_run(got, want)
    res = got[1].summary()['resilience']
    assert res['straggler_flags'] >= 1 and res['evictions'] >= 1
    assert {i['replica'] for k, _, i in got[1].events
            if k == 'straggler_flag'} == {0}
    _bit_exact(setup['port'], pair[1], got[0], setup['thr'])


def test_pool_elastic_scaling(setup):
    elastic, want = _both(setup, _pool(setup['thr'], replicas=1,
                                       max_replicas=4),
                          _trace(setup, 4 * SLOTS, rate=50000.0))
    _same_run(elastic, want)
    fixed, want = _both(setup, _pool(setup['thr'], replicas=1,
                                     max_replicas=1),
                        _trace(setup, 4 * SLOTS, rate=50000.0))
    _same_run(fixed, want)
    res = elastic[1].summary()['resilience']
    assert res['scale_ups'] >= 1 and res['peak_replicas'] >= 2
    assert fixed[1].summary()['resilience']['peak_replicas'] == 1
    assert max(c.t_done for c in elastic[0].values()) < \
        max(c.t_done for c in fixed[0].values())


def test_pool_slo_never_late_under_chaos(setup):
    n = 4 * SLOTS
    budgets = np.random.default_rng(7).uniform(0.4, 4.0, n) * sum(COSTS)
    pair = _trace(setup, n, rate=4000.0, budgets=budgets)
    got, want = _both(setup, _pool(
        setup['thr'], replicas=2, min_replicas=2, slo=True,
        chaos=dict(kills=((5e-3, None),), slowdowns=((0.0, 1, 2.0),))),
        pair, traced=True)
    _same_run(got, want)
    s = got[1].summary()
    assert len(got[0]) + s['n_rejected'] == n
    assert s['slo']['n_late'] == 0 and s['resilience']['kills'] == 1
    assert all(c.on_time for c in got[0].values())
    _bit_exact(setup['port'], pair[1], got[0], setup['thr'])


# ----------------------------------------------------------- metrics


def _metrics(pkg):
    m = pkg.ServingMetrics()
    m.record_rejection(7, 0.5, 'admission', t_arrival=0.001)
    for i, (lat, dl) in enumerate([(0.01, 0.02), (0.02, 0.015),
                                   (0.03, None), (0.04, 0.05)]):
        m.record_completion(pkg.Completion(
            rid=i, logits=None, pred=0, exit_stage=(0 if i < 2 else -1),
            t_arrival=0.002 * i, t_done=0.002 * i + lat, t_start=0.002 * i,
            deadline=None if dl is None else 0.002 * i + dl,
            degraded=i == 1))
    for t, stage, live, dev in ((0.0, 0, 4, 0), (0.004, 1, 2, 1),
                                (0.01, 0, 3, 0)):
        m.record_batch(stage, live, 8, t=t, cost=0.003, device=dev)
    m.record_event('pool_start', 0.0, n_replicas=2)
    m.record_event('kill', 0.01, replica=0, mid_batch=True)
    m.record_event('failover', 0.01, replica=2, n_replicas=2)
    m.record_event('scale_up', 0.02, replica=3, n_replicas=3)
    m.record_gauge('queue_depth', 0.005, 4)
    return m


def test_metrics_blocks_match_reference():
    got, want = _metrics(T), _metrics(J)
    assert got.summary() == want.summary()
    s = got.summary()
    assert s['slo'] == {'n_with_deadline': 4, 'n_on_time': 2, 'n_late': 1,
                        'attainment': 0.5}
    assert s['resilience']['kills'] == 1 and \
        s['resilience']['peak_replicas'] == 3
    assert s['n_degraded'] == 1 and s['availability'] == 0.8
    assert got.t_first_offered == 0.0 and got.t_first_arrival == 0.0
    assert got.device_occupancy(4) == want.device_occupancy(4)
    assert set(got.device_occupancy(4)) == {'0', '1'}
    assert got.timeseries(4) == want.timeseries(4)
    assert got.telemetry_digest(4) == want.telemetry_digest(4)
    assert T.ServingMetrics().device_occupancy() == {}


# ---------------------------------------------------------- placement

costs_st = st.lists(st.floats(0.0, 1e4, allow_nan=False,
                              allow_infinity=False),
                    min_size=1, max_size=24)


def _same_placement(got, want):
    assert got.assignment == want.assignment and got.loads == want.loads
    assert (got.opt_lower, got.guarantee, got.bound, got.n_devices) == \
        (want.opt_lower, want.guarantee, want.bound, want.n_devices)
    assert got.summary() == want.summary()


@settings(max_examples=150, deadline=None)
@given(costs=costs_st, n=st.integers(1, 12), seed=st.integers(0, 2**31 - 1))
def test_placement_matches_reference_within_guarantee(costs, n, seed):
    p = T.solve_placement(costs, n, seed=seed)
    _same_placement(p, j_solve_placement(costs, n, seed=seed))
    assert set(dict(p.assignment)) == {(DEFAULT_MODEL, k)
                                       for k in range(len(costs))}
    total = sum(costs)
    tol = 1e-9 * max(1.0, total)
    assert abs(sum(p.loads) - total) <= tol
    assert p.max_load <= p.guarantee + tol
    assert p.opt_lower <= p.max_load + tol
    for k in range(len(costs)):
        assert (DEFAULT_MODEL, k) in p.stages_on(p.device_of(k))


@settings(max_examples=80, deadline=None)
@given(models=st.dictionaries(
           st.sampled_from(['cnn-a', 'cnn-b', 'cnn-c']),
           st.lists(st.floats(0.0, 100.0), min_size=1, max_size=6),
           min_size=1, max_size=3),
       n=st.integers(1, 8))
def test_multi_model_placement_matches_reference(models, n):
    _same_placement(T.solve_placement(models, n),
                    j_solve_placement(models, n))


def test_placement_degenerate_and_invalid_inputs():
    one = T.solve_placement([5.0, 1.0, 2.0], 1)
    assert one.loads == (8.0,) and one.balance == 1.0
    zeros = T.solve_placement([0.0, 0.0, 0.0], 4)
    assert zeros.max_load == 0.0 and zeros.balance == 1.0
    for bad in (([1.0], 0), ([], 2), ([1.0, -2.0], 2), ([float('nan')], 2),
                ({'a': []}, 2)):
        with pytest.raises(ValueError):
            T.solve_placement(*bad)
    rs = [lpt_ratio(n) for n in range(1, 16)]
    assert rs[0] == 1.0 and rs == sorted(rs) and all(r < 4 / 3 for r in rs)


def test_registry_plans_placement_like_reference(setup, tmp_path):
    (treg, tmodel), (jreg, jmodel) = _chain_dirs(setup, tmp_path)
    treg.register('b', setup['port'])
    jreg.register('b', setup['ref'])
    costs = {'m': [3.0, 2.0, 1.0], 'b': [2.5, 2.5, 0.5]}
    _same_placement(treg.plan_placement(2, costs, seed=3),
                    jreg.plan_placement(2, costs, seed=3))
    assert treg.names() == ['b', 'm'] and 'm' in treg and len(treg) == 2
    with pytest.raises(ValueError, match='already registered'):
        treg.register('m', tmodel)
    with pytest.raises(KeyError):
        treg.get('missing')
    with pytest.raises(KeyError, match='checkpoint source'):
        treg.restore('b')
    with pytest.raises(ValueError, match='missing'):
        treg.plan_placement(2, {'m': [1.0, 1.0, 1.0]})
    with pytest.raises(ValueError, match='stage costs'):
        treg.plan_placement(2, {'m': [1.0], 'b': [1.0, 1.0, 1.0]})
    with pytest.raises(ValueError, match='no models'):
        T.ModelRegistry().plan_placement(2, {})
