"""The port's compression chain (D, P, L, Q, E, the planner, ``Pipeline``,
``export_chain``) against the JAX package, on the same numpy inputs.

resnet8 / vgg8 / mobilenet-small at their registry widths on 16x16 images
(the families' cost model keeps the 32x32 image of the configs).  Weights
cross through ``repro_torch.interop``; batches are shared through
subclassed families that return fixed batches, fixed initial weights and
fixed exit heads, so the two packages' random streams never enter.
Tolerances, each with its reason:

* ``shrink``, ``prune``, the costs, the factorization and the planner:
  exact (index gathers, numpy SVD and argsort, analytic BitOps);
* the losses: 1e-5 relative; their gradients: 1e-5 x the largest
  gradient magnitude of the tree (fp32 convs sum in other orders in XLA
  and torch), against ``jax.jit`` of the reference's loss, at bits 0,
  W2A8 and W8A8;
* ``exit_stats``: equal (the confidences are far from the thresholds);
* one step of each pass: the bands of ``test_torch_train.py``'s Q step,
  no element more than 0.25 x lr apart and at most 0.1% of the elements
  more than 1e-2 x lr apart (AdamW's first step is about +-lr whatever
  |g| is), lr the pass's own;
* the exported chain: at most 1% of the int8 carry codes differ at each
  stage boundary on the reference's static scales, logits within 4e-2 x
  max|logit| (the reference's own Pallas-vs-jnp tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn as jcnn
from repro.core import chain as jchain
from repro.core import family as jfamily
from repro.core import passes as jpasses
from repro.core import planner as jplanner
from repro.core import registry as jregistry
from repro.core.export import export_chain as j_export_chain
from repro.data import SyntheticImages as JImages
from repro_torch.configs import cnn as tcnn
from repro_torch.core import chain as tchain
from repro_torch.core import export as texport
from repro_torch.core import family as tfamily
from repro_torch.core import passes as tpasses
from repro_torch.core import planner as tplanner
from repro_torch.core import registry as tregistry
from repro_torch.core.quantization import jitted_scales
from repro_torch.data import SyntheticImages
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

KINDS = ('resnet8-cifar', 'vgg8-cifar', 'mobilenet-small-cifar')
B, HW, LR = 4, 16, 1e-3
HPS = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
       'L': {'energy': 0.9, 'min_rank': 4}, 'Q': {'w_bits': 2, 'a_bits': 8},
       'E': {'threshold': 0.15}}


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, HW, HW, 3)).astype(np.float32),
            rng.integers(0, 10, size=n))


def _jb(b):
    return jnp.asarray(b[0]), jnp.asarray(b[1].astype(np.int32))


def _tb(b):
    return torch.from_numpy(b[0]), torch.from_numpy(b[1].astype(np.int64))


_INITS = {}


def _init(cfg):
    """The reference's weights for ``cfg`` (key 0), as numpy, cached by
    the config's fields."""
    k = tuple(dataclasses.astuple(cfg))
    if k not in _INITS:
        p = jfamily.CNNFamily(JImages()).init(jax.random.key(0), cfg)
        _INITS[k] = jax.tree.map(np.asarray, p)
    return _INITS[k]


def _head(s, dim, classes):
    rng = np.random.default_rng(100 + s)
    return {'w': (rng.standard_normal((dim, classes))
                  * np.sqrt(1.0 / dim)).astype(np.float32),
            'b': np.zeros((classes,), np.float32)}


def _jcfg(tcfg):
    return jcnn.CNNConfig(**dataclasses.asdict(tcfg))


class _JFixed(jfamily.CNNFamily):
    """The reference's family on fixed batches, weights and exit heads."""

    def train_batch(self, key, n):
        return _jb(_batch(1))

    def eval_batches(self, n, batch, seed=10_000):
        return [_jb(_batch(2, 16)), _jb(_batch(3, 16))]

    def init(self, key, cfg):
        return jax.tree.map(jnp.asarray, _init(cfg))

    def add_exits(self, key, params, cfg, stages):
        params, cfg = super().add_exits(key, params, cfg, stages)
        params['exits'] = {
            s: jax.tree.map(jnp.asarray, _head(int(s), h['w'].shape[0],
                                               cfg.num_classes))
            for s, h in params['exits'].items()}
        return params, cfg


class _TFixed(tfamily.CNNFamily):
    def train_batch(self, gen, n):
        return _tb(_batch(1))

    def eval_batches(self, n, batch, seed=10_000):
        return [_tb(_batch(2, 16)), _tb(_batch(3, 16))]

    def init(self, gen, cfg):
        return from_jax_params(_init(_jcfg(cfg)))

    def add_exits(self, gen, params, cfg, stages):
        params, cfg = super().add_exits(gen, params, cfg, stages)
        params['exits'] = {
            s: from_jax_params(_head(int(s), h['w'].shape[0],
                                     cfg.num_classes))
            for s, h in params['exits'].items()}
        return params, cfg


def _families():
    return _JFixed(JImages()), _TFixed(SyntheticImages(), device='cpu')


def _same_tree(got, want):
    """Bit for bit: same leaves, shapes and values, in the same order."""
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(b).view(np.uint8))


def _close_grads(got, want, rtol):
    """Every leaf within ``rtol`` x the largest magnitude in the tree: a
    conv bias ahead of a one-channel GroupNorm group has a gradient that
    is 0 but for float noise, so a leaf's own scale is no yardstick."""
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    top = max(float(np.abs(np.asarray(b)).max(initial=0.0)) for b in want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max(initial=0.0)) <= rtol * top


def _cfgs_equal(tcfg, jcfg):
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


# ------------------------------------------------------------ family hooks


@pytest.mark.parametrize('name', KINDS)
def test_shrink_matches_reference(name):
    jf, tf = _families()
    for factor in (0.5, 0.25, 1.0):
        _cfgs_equal(tf.shrink(tcnn.CNN_REGISTRY[name], factor),
                    jf.shrink(jcnn.CNN_REGISTRY[name], factor))


def _kept(pruned, full):
    """Indices of ``full``'s last-axis slices that ``pruned`` kept."""
    f = full.reshape(-1, full.shape[-1])
    p = pruned.reshape(-1, pruned.shape[-1])
    return [int(np.flatnonzero((f == p[:, [j]]).all(0))[0])
            for j in range(p.shape[1])]


@pytest.mark.parametrize('name', KINDS)
def test_prune_matches_reference(name):
    """Bit for bit, with the same kept channels; a factored tree raises."""
    jf, tf = _families()
    cfg = tcnn.CNN_REGISTRY[name]
    p = _init(cfg)
    tp, tc = tf.prune(from_jax_params(p), cfg, 0.3)
    jp, jc = jf.prune(jax.tree.map(jnp.asarray, p), _jcfg(cfg), 0.3)
    _cfgs_equal(tc, jc)
    _same_tree(tp, jp)
    blk, key = (('stages', 0, 0), 'expand' if cfg.kind == 'mobilenet'
                else 'conv1')
    full = p[blk[0]][blk[1]][blk[2]][key]['w']
    got = tp['stages'][0][0][key]['w'].numpy()
    want = np.asarray(jp['stages'][0][0][key]['w'])
    assert _kept(got, full) == _kept(want, full)
    assert len(_kept(got, full)) == max(4, int(full.shape[-1] * 0.7))
    fp, _, _ = tf.factorize(from_jax_params(p), cfg, energy=0.5, min_rank=2)
    with pytest.raises(ValueError, match='apply P before L'):
        tf.prune(fp, cfg, 0.3)


@pytest.mark.parametrize('name', KINDS)
def test_costs_match_reference(name):
    jf, tf = _families()
    cfg = tcnn.CNN_REGISTRY[name]
    p = _init(cfg)
    tp, tc = tf.prune(from_jax_params(p), cfg, 0.3)
    jp, jc = jf.prune(jax.tree.map(jnp.asarray, p), _jcfg(cfg), 0.3)
    assert tf.pruned_bitops_scale(0.3, tc) == jf.pruned_bitops_scale(0.3, jc)
    for bits in ((0, 0), (2, 8), (8, 8)):
        tq, jq = (c.replace(w_bits=bits[0], a_bits=bits[1])
                  for c in (tc, jc))
        assert tf.bitops(tq) == jf.bitops(jq)
        assert tf.bitops(tq, None, 0.35) == jf.bitops(jq, None, 0.35)
        ep = {0: 0.25, 1: 0.5}
        assert tf.bitops(tq, ep, 0.35) == jf.bitops(jq, ep, 0.35)
        assert tf.storage_bits(tp, tq) == jf.storage_bits(jp, jq)


def _exit_state(name):
    """(port params, reference params, port cfg, reference cfg) of
    ``name`` with exit heads at the default stages."""
    jf, tf = _families()
    cfg = tcnn.CNN_REGISTRY[name]
    stages = tf.default_exit_points(cfg)
    tp, tc = tf.add_exits(None, tf.init(None, cfg), cfg, stages)
    jp, jc = jf.add_exits(jax.random.key(0), jf.init(None, _jcfg(cfg)),
                          _jcfg(cfg), stages)
    return tp, jp, tc, jc


def _j_kd_loss(fam, t_params, t_cfg, temp, alpha):
    """The reference's distillation loss, as ``repro/core/passes.py``'s
    ``_distill`` defines it (a closure there)."""
    def kd_loss(p, cfg, batch):
        ce, s_logits = fam.loss(p, cfg, batch)
        t_logits = jax.lax.stop_gradient(fam.logits_of(t_params, t_cfg,
                                                       batch))
        kl = jnp.mean(jnp.sum(
            jax.nn.softmax(t_logits / temp)
            * (jax.nn.log_softmax(t_logits / temp)
               - jax.nn.log_softmax(s_logits / temp)), axis=-1)) * temp ** 2
        return alpha * kl + (1 - alpha) * ce, s_logits
    return kd_loss


@pytest.mark.parametrize('name,bits', [
    (name, bits) for name in KINDS for bits in ((0, 0), (2, 8))]
    + [('resnet8-cifar', (8, 8))])
def test_losses_match_reference(name, bits):
    """``loss``, ``exit_loss`` and the distillation loss: values and
    gradients against ``jax.jit`` of the reference's, the port's QAT
    scales under ``jitted_scales``."""
    jf, tf = _families()
    tp, jp, tc, jc = _exit_state(name)
    tc, jc = (c.replace(w_bits=bits[0], a_bits=bits[1]) for c in (tc, jc))
    teacher = _init(tcnn.CNN_REGISTRY[name])
    t_cfg = tcnn.CNN_REGISTRY[name]
    losses = (('loss', tf.loss, jf.loss), ('exit_loss', tf.exit_loss,
                                           jf.exit_loss),
              ('kd', tpasses.kd_loss(tf, from_jax_params(teacher), t_cfg,
                                     2.0, 0.5),
               _j_kd_loss(jf, jax.tree.map(jnp.asarray, teacher),
                          _jcfg(t_cfg), 2.0, 0.5)))
    b = _batch(1)
    # the three reference losses under one jax.jit (one compile)
    want = jax.jit(lambda p: tuple(
        jax.value_and_grad(lambda q, f=j_fn: f(q, jc, _jb(b)),
                           has_aux=True)(p) for _, _, j_fn in losses))(jp)
    for (what, t_fn, _), ((jl, _), jg) in zip(losses, want):
        with jitted_scales():
            tl, tg = tpasses.value_and_grad(t_fn, tc, tp, _tb(b))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), what
        _close_grads(tg, jg, 1e-5)


@pytest.mark.parametrize('bits', [(0, 0), (8, 8)])
def test_exit_stats_match_reference(bits):
    jf, tf = _families()
    tp, jp, tc, jc = _exit_state('resnet8-cifar')
    tc, jc = (c.replace(w_bits=bits[0], a_bits=bits[1]) for c in (tc, jc))
    for thr in (0.285, 0.43):       # inside stage 0's and stage 1's spread
        got = tf.exit_stats(tp, tc, tf.eval_batches(2, 16), thr)
        want = jf.exit_stats(jp, jc, jf.eval_batches(2, 16), thr)
        assert got == want
        assert any(0 < v < 1 for v in got[1].values())


def test_cnn_init_draws_on_the_cpu_for_every_device(monkeypatch):
    """``init_chain_state`` (and D's student, E's heads) draw a CNN's
    weights from a CPU generator whatever the family's device: the CNN
    draws on the CPU and moves the result.  The recording family stops
    before anything touches the card, so the test lets it be made for
    ``'cuda'`` on a host without one."""
    seen = []

    class Recording(tfamily.CNNFamily):
        def init(self, gen, cfg):
            seen.append(gen.device.type)
            raise StopIteration

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    fam = Recording(SyntheticImages(), device='cuda')
    with pytest.raises(StopIteration):
        tpasses.init_chain_state(fam, tcnn.RESNET8_CIFAR, 0,
                                 tpasses.Trainer(steps=0))
    assert seen == ['cpu']
    assert fam.generator(5).device.type == 'cpu'
    cpu = tfamily.CNNFamily(SyntheticImages(), device='cpu')
    a = cpu.init(cpu.generator(3), tcnn.RESNET8_CIFAR)
    b = cpu.init(fam.generator(3), tcnn.RESNET8_CIFAR)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize('kind', ['cnn', 'lm'])
def test_family_runs_on_the_card_unless_asked(kind):
    """A family made without a device runs on the card; on a host with no
    card it raises rather than fall back to the CPU."""
    from repro_torch.data import SyntheticTokens
    make = {'cnn': lambda: tfamily.CNNFamily(SyntheticImages()),
            'lm': lambda: tfamily.LMFamily(SyntheticTokens(64), seq=8)}[kind]
    if torch.cuda.is_available():
        assert make().device == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make()


# ------------------------------------------------------ one step a pass


def _start(key):
    """(port state, reference state) the pass ``key`` starts from: resnet8
    at its registry widths, bits 0, no exits; vgg8 for D.  resnet8's
    student has 8-channel convs in stage 0, each GroupNorm group one
    channel, so their biases have gradients that are 0 but for float
    noise, which AdamW scales to about +-lr: no band holds them (the
    chain test runs resnet8's D at steps=0).  vgg8's student is cut in
    depth and keeps its widths."""
    jf, tf = _families()
    cfg = tcnn.VGG8_CIFAR if key == 'D' else tcnn.RESNET8_CIFAR
    p = _init(cfg)
    return (tpasses.ChainState(family=tf, cfg=cfg, params=from_jax_params(p),
                               key=0),
            jpasses.ChainState(family=jf, cfg=_jcfg(cfg),
                               params=jax.tree.map(jnp.asarray, p),
                               key=jax.random.key(0)))


@pytest.mark.parametrize('key', list('DPLQE'))
def test_pass_step_matches_reference(key):
    """One training step of each pass (D trains three: its student gets
    3 x ``steps``) through the registry, on fixed batches, from shared
    weights."""
    tst, jst = _start(key)
    ttr = tpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=2, eval_batch=16)
    jtr = jpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=2, eval_batch=16)
    tnew = tregistry.get_pass(key).apply(tst, HPS[key], ttr)
    jnew = jregistry.get_pass(key).apply(jst, HPS[key], jtr)
    _cfgs_equal(tnew.cfg, jnew.cfg)
    lr = LR if key in 'DE' else LR / 10
    got = tree_leaves(to_numpy(tnew.params))
    want = jax.tree.leaves(jnew.params)
    assert [a.shape for a in got] == [np.shape(b) for b in want]
    near = n = 0
    for a, b in zip(got, want):
        d = np.abs(a - np.asarray(b))
        assert float(d.max()) <= 0.25 * lr, key
        near += int((d > 1e-2 * lr).sum())
        n += d.size
    assert near <= 1e-3 * n
    assert (tnew.prune_scale, tnew.lowrank_scale) == \
        (jnew.prune_scale, jnew.lowrank_scale)
    assert tnew.exit_threshold == jnew.exit_threshold
    if key == 'E':
        assert tnew.exit_probs == jnew.exit_probs
        assert tnew.dyn_accuracy == jnew.dyn_accuracy
    assert tnew.key == tpasses.fold_in(0, {'D': 2, 'P': 3, 'L': 7, 'Q': 4,
                                           'E': 6}[key])


# ------------------------------------------------------ the whole chain


@pytest.fixture(scope='module')
def chains():
    """DPLQE at steps=0 through both packages' ``Pipeline``: (port state,
    reference state)."""
    jf, tf = _families()
    ttr = tpasses.Trainer(batch=B, steps=0, lr=LR, eval_n=2, eval_batch=16)
    jtr = jpasses.Trainer(batch=B, steps=0, lr=LR, eval_n=2, eval_batch=16)
    cfg = tcnn.RESNET8_CIFAR
    t = tchain.Pipeline.from_sequence('DPLQE', HPS).run(
        tf, cfg, ttr, pretrain_steps=0)
    j = jchain.Pipeline.from_sequence('DPLQE', HPS).run(
        jf, _jcfg(cfg), jtr, pretrain_steps=0)
    return t, j


def _ranks(params):
    """The rank of every factored weight, by path."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            if 'u' in t and 'v' in t:
                out[path] = int(np.shape(t['u']['w'])[-1])
                return
            for k in t:
                walk(t[k], f'{path}/{k}')
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f'{path}/{i}')
    walk(params, '')
    return out


def test_dplqe_chain_at_zero_steps_matches_reference(chains):
    t, j = chains
    assert [h['pass'] for h in t.history] == \
        ['baseline', 'D', 'P', 'L', 'Q', 'E'] == \
        [h['pass'] for h in j.history]
    for a, b in zip(t.history, j.history):
        assert (a['BitOpsCR'], a['CR']) == (b['BitOpsCR'], b['CR'])
        assert abs(a['acc'] - b['acc']) <= 1 / 32     # one eval sample
    _cfgs_equal(t.cfg, j.cfg)
    assert [a.shape for a in tree_leaves(t.params)] == \
        [np.shape(b) for b in jax.tree.leaves(j.params)]
    assert _ranks(to_numpy(t.params)) == _ranks(j.params)
    assert _ranks(j.params)                     # L factored something
    assert t.exit_probs == j.exit_probs and t.exit_threshold == 0.15
    assert (t.prune_scale, t.lowrank_scale, t.base_bitops, t.base_bits) == \
        (j.prune_scale, j.lowrank_scale, j.base_bitops, j.base_bits)


def test_q_after_e_remeasures_at_es_threshold(chains):
    """Q applied after E re-measures the exit statistics at E's threshold,
    in both packages."""
    t, j = chains
    ttr = tpasses.Trainer(batch=B, steps=0, lr=LR, eval_n=2, eval_batch=16)
    jtr = jpasses.Trainer(batch=B, steps=0, lr=LR, eval_n=2, eval_batch=16)
    hp = {'w_bits': 8, 'a_bits': 8}
    tq = tregistry.get_pass('Q').apply(t, hp, ttr)
    jq = jregistry.get_pass('Q').apply(j, hp, jtr)
    assert tq.exit_probs == jq.exit_probs
    assert tq.dyn_accuracy == jq.dyn_accuracy
    assert tq.exit_threshold == 0.15
    assert tq.exit_probs == tq.family.exit_stats(
        tq.params, tq.cfg, tq.family.eval_batches(2, 16), 0.15)[1]


# ---------------------------------------------------------------- planner


def test_planner_matches_reference():
    assert tregistry.registered_keys() == ('D', 'E', 'L', 'P', 'Q')
    assert tplanner.theoretical_order() == 'DPLQE' == \
        jplanner.theoretical_order()
    for keys in (None, 'DPQE', 'QLD'):
        assert tplanner.theoretical_dag(keys) == \
            jplanner.theoretical_dag(keys)
        assert tplanner.theoretical_order(keys) == \
            jplanner.theoretical_order(keys)
    rng = np.random.default_rng(0)
    for _ in range(5):
        ab = [tuple(v) for v in rng.uniform(1, 50, (6, 2))]
        ba = [tuple(v) for v in rng.uniform(1, 50, (6, 2))]
        assert tplanner.pareto_frontier(ab) == jplanner.pareto_frontier(ab)
        assert tplanner.frontier_score(ab) == jplanner.frontier_score(ab)
        assert tplanner.frontier_score(ab, (2.0, 30.0)) == \
            jplanner.frontier_score(ab, (2.0, 30.0))
        assert tplanner.compare_orders(ab, ba, 'P', 'Q') == \
            jplanner.compare_orders(ab, ba, 'P', 'Q')
    tie = [(0.5, 4.0), (0.7, 2.0)]
    for a, b in (('Q', 'P'), ('P', 'Q'), (None, None)):
        assert tplanner.compare_orders(tie, tie, a, b) == \
            jplanner.compare_orders(tie, tie, a, b)
    assert tplanner.frontier_score([]) == jplanner.frontier_score([]) == 0.0


def test_order_planner_matches_reference():
    edges = [('P', 'Q', 'AB', 0.3), ('Q', 'E', 'AB', 0.2),
             ('D', 'P', 'AB', 0.5), ('E', 'P', 'AB', 0.0),
             ('L', 'Q', 'AB', 0.4)]
    pl = [tplanner.OrderPlanner(), jplanner.OrderPlanner()]
    for p in pl:
        for a, b, w, m in edges:
            p.add_pairwise(a, b, w, margin=m)
    assert pl[0].pairs() == pl[1].pairs()
    for p in pl:
        with pytest.raises(ValueError, match='cycle'):
            p.topological_order()
    assert pl[0].resolve_cycles() == pl[1].resolve_cycles() == \
        [('E', 'P')]
    assert pl[0].topological_order() == pl[1].topological_order()
    assert tplanner.OrderPlanner('PQ').topological_order() == 'PQ'
    with pytest.raises(KeyError):
        tplanner.OrderPlanner('PZ')


# --------------------------------------------------------------- Pipeline


def test_pipeline_validates_as_the_reference():
    for P in (tchain.Pipeline, jchain.Pipeline):
        with pytest.raises(KeyError, match='unknown pass'):
            P.from_sequence('DPX')
        with pytest.raises(ValueError, match='duplicate pass keys'):
            P.from_sequence('DPP')
        assert P.from_sequence('DPP', allow_repeats=True).sequence == 'DPP'
        with pytest.raises(ValueError, match='not in sequence'):
            P.from_sequence('DP', {'Q': {'w_bits': 4}})
        with pytest.raises(TypeError, match='unknown hyperparameters'):
            P.from_sequence('Q', {'Q': {'w_bit': 4}})
        with pytest.raises(ValueError, match='empty'):
            P.from_sequence('')
    t = tchain.Pipeline.from_sequence('DPLQE', HPS)
    j = jchain.Pipeline.from_sequence('DPLQE', HPS)
    assert [dataclasses.asdict(h) for _, h in t.steps] == \
        [dataclasses.asdict(h) for _, h in j.steps]
    assert tchain.Pipeline.auto(tplanner.OrderPlanner('PQ')).sequence == 'PQ'
    assert tchain.OPTIMAL_SEQUENCE == jchain.OPTIMAL_SEQUENCE
    from repro.analysis import AnalysisError as JAnalysisError
    from repro_torch.analysis import AnalysisError
    assert tchain.Pipeline.from_sequence(
        'DP', verify_order=True).sequence == 'DP'
    assert t.verify_order().ok and j.verify_order().ok
    for P, err in ((tchain.Pipeline, AnalysisError),
                   (jchain.Pipeline, JAnalysisError)):
        with pytest.raises(err, match='P→Q'):
            P.from_sequence('QP', verify_order=True)


def test_pipeline_resumes_from_its_checkpoints(tmp_path):
    """A probe pass counts its runs: a second ``run`` on the same
    ``checkpoint_dir`` applies nothing and returns the same params; a
    longer pipeline runs only its new pass; a pipeline whose prefix is not
    on disk raises."""
    @dataclasses.dataclass(frozen=True)
    class HP:
        x: int = 1

    ran = []

    def probe(state, hp, trainer):
        ran.append(hp.x)
        return dataclasses.replace(state, key=tpasses.fold_in(state.key, 9))

    tregistry.register(tregistry.CompressionPass(
        'Z', 'probe', 'static', 'neuron', HP, probe))
    try:
        assert tregistry.registered_keys() == ('D', 'E', 'L', 'P', 'Q', 'Z')
        fam = tfamily.CNNFamily(SyntheticImages(size=HW), device='cpu')
        tr = tpasses.Trainer(batch=B, steps=0, eval_n=1, eval_batch=8)
        d = str(tmp_path / 'ck')
        pipe = tchain.Pipeline.from_sequence('PZ', {'P': {'ratio': 0.5}})
        first = pipe.run(fam, tcnn.RESNET8_CIFAR, tr, pretrain_steps=1,
                         checkpoint_dir=d)
        assert ran == [1]
        again = pipe.run(fam, tcnn.RESNET8_CIFAR, tr, checkpoint_dir=d)
        assert ran == [1]
        assert [h['pass'] for h in again.history] == ['baseline', 'P', 'Z']
        assert again.key == first.key
        for a, b in zip(tree_leaves(again.params), tree_leaves(first.params)):
            assert torch.equal(a, b)
        longer = tchain.Pipeline.from_sequence(
            'PZQ', {'P': {'ratio': 0.5}, 'Z': {'x': 2}})
        longer.run(fam, tcnn.RESNET8_CIFAR, tr, checkpoint_dir=d)
        assert ran == [1]                # only Q ran
        with pytest.raises(ValueError, match='starts with'):
            tchain.Pipeline.from_sequence('QZP').run(
                fam, tcnn.RESNET8_CIFAR, tr, checkpoint_dir=d)
        with pytest.raises(ValueError, match='only runs'):
            tchain.Pipeline.from_sequence('P').run(
                fam, tcnn.RESNET8_CIFAR, tr, checkpoint_dir=d)
    finally:
        tregistry.unregister('Z')


def test_passes_view_is_the_registry():
    assert list(tpasses.PASSES) == list(tregistry.registered_keys())
    assert len(tpasses.PASSES) == 5
    assert tpasses.PASSES['E'] is tregistry.get_pass('E')
    for k in 'DPLQE':
        tp_, jp_ = tregistry.get_pass(k), jregistry.get_pass(k)
        assert (tp_.name, tp_.kind, tp_.granularity, tp_.rank) == \
            (jp_.name, jp_.kind, jp_.granularity, jp_.rank)
        assert dataclasses.asdict(tp_.resolve_hp(None)) == \
            dataclasses.asdict(jp_.resolve_hp(None))


def test_sweep_exit_thresholds_matches_reference(chains):
    t, j = chains
    ttr = tpasses.Trainer(eval_n=2, eval_batch=16)
    jtr = jpasses.Trainer(eval_n=2, eval_batch=16)
    assert tchain.sweep_exit_thresholds(t, ttr, (0.12, 0.2)) == \
        jchain.sweep_exit_thresholds(j, jtr, (0.12, 0.2))


# ------------------------------------------------------------ export_chain


def test_serving_backend_registry():
    class Sub(tfamily.CNNFamily):
        pass

    assert texport.serving_backend_for(Sub(None, device='cpu')) is \
        texport.serving_backend_for(tfamily.CNNFamily(None, device='cpu'))

    class Stranger:
        pass

    st = tpasses.ChainState(family=Stranger(), cfg=None, params=None, key=0)
    with pytest.raises(KeyError, match='no serving backend'):
        texport.export_chain(st)
    seen = []
    texport.register_serving_backend(
        Stranger, lambda state, device: seen.append(device) or
        texport.ServingModel(cfg=None, params=None, fn=None))
    try:
        st.exit_threshold = 0.33
        assert texport.export_chain(st, device='cpu').exit_threshold == 0.33
        assert seen == ['cpu']
        with pytest.raises(TypeError, match='calibrate'):
            texport.export_chain(st, device='cpu', calibrate=torch.zeros(1))
    finally:
        del texport._SERVING_BACKENDS[Stranger]


def test_lm_backend_refuses_a_calibration_batch():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticTokens
    cfg = get_smoke_config('tinyllama-1.1b', layers=1)
    fam = tfamily.LMFamily(SyntheticTokens(cfg.vocab_size), seq=8,
                            device='cpu')
    st = tpasses.ChainState(family=fam, cfg=cfg, params=None, key=0)
    with pytest.raises(TypeError, match='calibrate'):
        texport.export_chain(st, calibrate=torch.zeros(1))


def test_pipeline_export_needs_the_dynamic_scale_export(chains):
    """``Pipeline.export`` compiles the finished chain with dynamic scales
    (``export_cnn(calibrate=None)``, no plan), the chain's operating point
    threaded in, as the reference's does; the logits within 4e-2 x
    max|logit| of the reference's Pallas-path export (the factored model,
    ROADMAP C), the early-exit decisions equal."""
    t, j = chains
    x = _batch(4, 4)[0]
    model = tchain.Pipeline.from_sequence('E').export(t, device='cpu')
    ref = jchain.Pipeline.from_sequence('E').export(j, use_pallas=True)
    assert model.plan is None and ref.plan is None
    assert model.exit_threshold == ref.exit_threshold == 0.15
    want = np.asarray(ref.serve(x))
    np.testing.assert_allclose(
        model.serve(torch.from_numpy(x)).numpy(), want, rtol=0,
        atol=4e-2 * max(float(np.abs(want).max()), 1.0))
    _, stage = model.serve_early_exit(torch.from_numpy(x))
    _, jstage = ref.serve_early_exit(x)
    np.testing.assert_array_equal(stage.numpy(), np.asarray(jstage))


def test_exported_chain_matches_reference(chains):
    """The DPLQE chain exported int8-resident by both packages: the
    operating point threaded into the model, the carry at each stage
    boundary on the reference's scales, the logits on each one's own."""
    t, j = chains
    x = _batch(4, 4)[0]
    model = texport.export_chain(t, device='cpu',
                                 calibrate=torch.from_numpy(x))
    # the reference's Pallas path (interpret mode): its jnp path serves
    # factored layers with other arithmetic (ROADMAP C, the reference's
    # own Pallas-vs-jnp failure)
    ref = j_export_chain(j, use_pallas=True, calibrate=x)
    assert model.exit_threshold == ref.exit_threshold == 0.15
    assert model.n_stages == ref.n_stages == len(t.cfg.exit_stages) + 1
    own = model.serve(torch.from_numpy(x)).numpy()
    for n, e in ref.plan.layers.items():
        for k in ('sx', 'out_scale', 'h_scale'):
            if k in e:
                model.plan.layers[n][k] = e[k]
    model.plan.glues.update(ref.plan.glues)
    th, jh = torch.from_numpy(x), x
    differ = []
    for k in range(ref.n_stages - 1):
        _, th = model.run_stage(k, th)
        _, jh = ref.run_stage(k, jh)
        assert th.q.dtype == torch.int8
        np.testing.assert_allclose(th.scale, jh.scale, rtol=1e-6)
        differ.append(float(np.mean(th.q.numpy() != np.asarray(jh.q))))
    print(f'int8 carry codes that differ at each stage boundary: {differ}')
    assert max(differ) <= 0.01
    want = np.asarray(ref.run_stage(ref.n_stages - 1, jh))
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(model.run_stage(model.n_stages - 1, th)
                               .numpy(), want, rtol=0, atol=4e-2 * scale)
    # ``want`` is the reference's own stages end to end: its serve(x)
    np.testing.assert_allclose(own, want, rtol=0, atol=4e-2 * scale)
