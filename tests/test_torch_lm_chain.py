"""The LM half of the port's compression chain (``LMFamily``'s hooks,
``transformer.forward(collect_hiddens=True)``, a DPLQE ``run_chain``, the
chain checkpoints and ``Pipeline.export``) against the JAX package, on
``get_smoke_config('tinyllama-1.1b', layers=4)`` with a 64-token vocab.

Weights cross through ``repro_torch.interop``; batches, initial weights
and exit heads are shared through subclassed families that return fixed
ones, so the two packages' random streams never enter.  Tolerances, each
with its reason:

* ``collect_hiddens``: the hiddens within 1e-5 x max|h| (XLA and torch
  sum the matmuls and softmaxes in other orders);
* ``shrink``, ``default_exit_points``, ``bitops``, ``prune`` (the same
  channels in the same order), the ranks and ``mac_scale``: exact; the
  CPU factors bit for bit (numpy's SVD, as the reference's); the card's
  path (the fp64 Gram eigendecomposition ``_gram_svd``, run here on the
  CPU) the same ranks and ``u @ v`` within 1e-4 x max|u @ v|, the chip
  gate's band (the sign of a singular pair is free; numpy's fp32 SVD,
  truncated inside a near-continuous spectrum, is 1e-6 to 2e-5 x max from
  the fp64 one here and at tinyllama's width);
* ``exit_logits``: 1e-5 x max|logit|; ``exit_loss``: 1e-5 relative, its
  gradients 1e-5 x the largest gradient magnitude of the tree, against
  ``jax.jit`` of the reference's, at bits 0 and W8A0 (``test_torch_chain``'s
  bands).  At W8A8 the loss holds 1e-5, the logits and gradients 2e-2 x
  max: a per-tensor activation code at a rounding tie flips wherever XLA
  and torch round an fp32 sum differently (ROADMAP C, "QAT across
  devices"), which moves them by up to 1.5e-2 x max here (the 2-layer
  W8A8 step of ``test_torch_train.py`` holds 1e-5: no tie there);
* ``exit_stats``: equal at bits 0 and W8A0 (no confidence within 1e-4 of
  the thresholds, which lie inside the heads' spread);
* a one-step DPLQE chain (Q at W8A0: at A8 a code flip at a tie moves
  exit confidences across E's threshold): the same configs, ranks and
  kept shapes, the records' BitOpsCR and CR equal, accuracies within two
  eval tokens;
* checkpoints: bit for bit both ways;
* ``Pipeline.export``: int8 codes and scales equal; the exported trees'
  logits in fp32 without activation quantization within 1e-3 x
  max|logit| (the bf16 model's own logits round at 4e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.chain_io import load_chain_state as j_load_chain
from repro.checkpoint.chain_io import save_chain_state as j_save_chain
from repro.configs import get_smoke_config as j_smoke
from repro.core import chain as jchain
from repro.core import family as jfamily
from repro.core import passes as jpasses
from repro.core.export import export_lm as j_export_lm
from repro.data import SyntheticTokens as JTokens
from repro.models import transformer as jtfm
from repro_torch.checkpoint import load_chain_state, save_chain_state
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import chain as tchain
from repro_torch.core import family as tfamily
from repro_torch.core import passes as tpasses
from repro_torch.core.quantization import jitted_scales
from repro_torch.data import SyntheticTokens
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCH = 'tinyllama-1.1b'
VOCAB, B, SEQ, LR = 64, 4, 16, 1e-3
HPS = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
       'L': {'energy': 0.6, 'min_rank': 8}, 'Q': {'w_bits': 8, 'a_bits': 0},
       'E': {'threshold': 0.03}}


def _cfgs(**kw):
    """(port cfg, reference cfg): the 4-layer smoke config, 64 tokens."""
    j = j_smoke(ARCH, layers=4).replace(vocab_size=VOCAB, **kw)
    return ModelConfig(**dataclasses.asdict(j)), j


def _tokens(seed, n=B):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, VOCAB, size=(n, SEQ + 1))
    return t[:, :-1], t[:, 1:]


def _jb(seed, n=B):
    t, y = _tokens(seed, n)
    return {'tokens': jnp.asarray(t, jnp.int32),
            'labels': jnp.asarray(y, jnp.int32)}


def _tb(seed, n=B):
    t, y = _tokens(seed, n)
    return {'tokens': torch.from_numpy(t), 'labels': torch.from_numpy(y)}


_INITS = {}


def _init(jcfg):
    """The reference's weights for ``jcfg`` (key 0), as numpy."""
    k = tuple(dataclasses.astuple(jcfg))
    if k not in _INITS:
        p = jax.jit(lambda key: jtfm.init_lm(key, jcfg))(jax.random.key(0))
        _INITS[k] = jax.tree.map(np.asarray, p)
    return _INITS[k]


def _head(g, d, dtype):
    rng = np.random.default_rng(200 + g)
    w = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    return {'norm': {'scale': np.ones((d,), dtype)},
            'adapter': {'w': w.astype(dtype)}}


def _np_dtype(cfg):
    return jnp.dtype(cfg.dtype)


class _JFixed(jfamily.LMFamily):
    """The reference's LM family on fixed batches, weights and heads."""

    def train_batch(self, key, n):
        return _jb(1)

    def eval_batches(self, n, batch, seed=10_000):
        return [_jb(2, 8), _jb(3, 8)]

    def init(self, key, cfg):
        return jax.tree.map(jnp.asarray, _init(cfg))

    def add_exits(self, key, params, cfg, groups):
        params, cfg = super().add_exits(key, params, cfg, groups)
        params['exit_heads'] = {
            g: jax.tree.map(jnp.asarray, _head(int(g), cfg.d_model,
                                               _np_dtype(cfg)))
            for g in params['exit_heads']}
        return params, cfg


class _TFixed(tfamily.LMFamily):
    def train_batch(self, gen, n):
        return _tb(1)

    def eval_batches(self, n, batch, seed=10_000):
        return [_tb(2, 8), _tb(3, 8)]

    def init(self, gen, cfg):
        return from_jax_params(_init(
            j_smoke(ARCH).replace(**dataclasses.asdict(cfg))))

    def add_exits(self, gen, params, cfg, groups):
        params, cfg = super().add_exits(gen, params, cfg, groups)
        params['exit_heads'] = {
            g: from_jax_params(_head(int(g), cfg.d_model,
                                     _np_dtype(cfg)))
            for g in params['exit_heads']}
        return params, cfg


def _families():
    return (_JFixed(JTokens(VOCAB), seq=SEQ),
            _TFixed(SyntheticTokens(VOCAB), seq=SEQ, device='cpu'))


def _same_tree(got, want):
    """Bit for bit: same leaves, shapes, dtypes and values, in order."""
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(b).view(np.uint8))


def _close(got, want, rtol):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= \
        rtol * float(np.abs(want).max())


def _close_grads(got, want, rtol):
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    top = max(float(np.abs(np.asarray(b)).max(initial=0.0)) for b in want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a - b).max(initial=0.0)) <= rtol * top


def _exit_state(**kw):
    """(port params, reference params, port cfg, reference cfg) with exit
    heads at the default points."""
    jf, tf = _families()
    tc, jc = _cfgs(**kw)
    groups = tf.default_exit_points(tc)
    tp, tc = tf.add_exits(None, tf.init(None, tc), tc, groups)
    jp, jc = jf.add_exits(jax.random.key(0), jf.init(None, jc), jc, groups)
    return tp, jp, tc, jc


# ------------------------------------------------------------- the forward


def test_collect_hiddens_matches_reference():
    tc, jc = _cfgs()
    p = _init(jc)
    b = _tokens(5)[0]
    jl, jh = jax.jit(lambda q, t: jtfm.forward(
        q, jc, t, collect_hiddens=True))(p, jnp.asarray(b, jnp.int32))
    tl, th = tfm.forward(from_jax_params(p), tc, torch.from_numpy(b),
                         collect_hiddens=True)
    assert len(th) == jh.shape[0] == 4
    for g in range(4):
        _close(th[g], jh[g], 1e-5)
    _close(tl, jl, 1e-5)
    assert torch.equal(tfm.forward(from_jax_params(p), tc,
                                   torch.from_numpy(b)), tl)


# ------------------------------------------------------------ family hooks


def test_shrink_exit_points_and_bitops_match_reference():
    jf, tf = _families()
    for layers in (4, 22, 5):
        tc, jc = _cfgs()
        tc, jc = (c.replace(num_layers=layers) for c in (tc, jc))
        for factor in (0.5, 0.25, 1.0):
            assert dataclasses.asdict(tf.shrink(tc, factor)) == \
                dataclasses.asdict(jf.shrink(jc, factor))
        assert tf.default_exit_points(tc) == jf.default_exit_points(jc)
        for bits in ((0, 0), (8, 8), (4, 8)):
            tq, jq = (c.replace(w_bits=bits[0], a_bits=bits[1])
                      for c in (tc, jc))
            assert tf.bitops(tq) == jf.bitops(jq)
            ep = {g: 0.25 * (i + 1)
                  for i, g in enumerate(tf.default_exit_points(tq))}
            assert tf.bitops(tq, ep, 0.6) == jf.bitops(jq, ep, 0.6)
    assert tf.shrink(_cfgs()[0].replace(num_layers=22), 0.5).num_layers == 11
    assert tf.default_exit_points(
        _cfgs()[0].replace(num_layers=11)) == (3, 7)


def _unstacked_cfgs():
    """A pattern of two with a prefix layer and a tail layer: prefix 1,
    groups 2 of 2, tail 1, so every kind of layer list is pruned."""
    return _cfgs(num_layers=6, block_pattern=('global', 'global'),
                 first_dense_layers=1)


@pytest.mark.parametrize('layout', ['stacked', 'unstacked'])
def test_prune_keeps_the_references_channels_in_its_order(layout):
    jf, tf = _families()
    tc, jc = _cfgs() if layout == 'stacked' else _unstacked_cfgs()
    p = _init(jc)
    tp, tc2 = tf.prune(from_jax_params(p), tc, 0.3)
    jp, jc2 = jf.prune(jax.tree.map(jnp.asarray, p), jc, 0.3)
    assert tc2.d_ff == jc2.d_ff == max(8, int(256 * 0.7)) == 179
    _same_tree(tp, jp)
    full = p['blocks'][0]['mlp']['wo']['w']            # (G, f, d)
    got = tp['blocks'][0]['mlp']['wo']['w'].numpy()
    for g in range(full.shape[0]):
        kept = [int(np.flatnonzero((full[g] == got[g][j]).all(1))[0])
                for j in range(got.shape[1])]
        assert kept != sorted(kept)                     # importance order
    if layout == 'unstacked':
        for grp in ('prefix', 'tail'):
            w = tp[grp][0]['mlp']['wi']['w']
            assert w.shape == (128, 179)
    fp, _, _ = tf.factorize(tp, tc2, energy=0.6)
    with pytest.raises(ValueError, match='apply P before L'):
        tf.prune(fp, tc2, 0.3)


def _ranks(params):
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


@pytest.mark.parametrize('layout', ['stacked', 'unstacked'])
def test_factorize_matches_reference(layout, monkeypatch):
    jf, tf = _families()
    tc, jc = _cfgs() if layout == 'stacked' else _unstacked_cfgs()
    p = _init(jc)
    jp, _, js = jf.factorize(jax.tree.map(jnp.asarray, p), jc, energy=0.6)
    tp, tc2, ts = tf.factorize(from_jax_params(p), tc, energy=0.6)
    assert ts == js and tc2 == tc
    assert _ranks(to_numpy(tp)) == _ranks(jp) and _ranks(jp)
    _same_tree(tp, jp)
    assert tp['blocks'][0]['mlp']['wi']['u']['w'].dtype == torch.float32
    # the card's path: the fp64 Gram eigendecomposition and the factors
    # on the device, run here on CPU tensors
    monkeypatch.setattr(tfamily, '_lm_svd', tfamily._gram_svd)
    dp, _, ds = tf.factorize(from_jax_params(p), tc, energy=0.6)
    assert ds == js and _ranks(to_numpy(dp)) == _ranks(jp)
    for grp in ('prefix', 'blocks', 'tail'):
        for lt, lj in zip(dp[grp], jp[grp]):
            for k in ('wi', 'wg', 'wo'):
                got = lt['mlp'][k]['u']['w'] @ lt['mlp'][k]['v']['w']
                want = np.asarray(lj['mlp'][k]['u']['w']) @ \
                    np.asarray(lj['mlp'][k]['v']['w'])
                _close(got, want, 1e-4)


def test_add_exits_draws_heads_on_the_family_device():
    _, tf = _families()
    tc, _ = _cfgs(dtype='bfloat16')
    fam = tfamily.LMFamily(SyntheticTokens(VOCAB), seq=SEQ, device='cpu')
    p, c = fam.add_exits(fam.generator(5), {'x': 1}, tc, (1, 2))
    assert c.exit_layers == (1, 2) and sorted(p['exit_heads']) == ['1', '2']
    a = p['exit_heads']['1']['adapter']['w']
    assert a.shape == (128, 128) and a.dtype == torch.bfloat16
    assert p['exit_heads']['2']['norm']['scale'].dtype == torch.bfloat16
    assert not torch.equal(a, p['exit_heads']['2']['adapter']['w'])


@pytest.mark.parametrize('bits', [(0, 0), (8, 0), (8, 8)])
def test_exit_logits_and_loss_match_reference(bits):
    band = 2e-2 if bits[1] else 1e-5
    jf, tf = _families()
    tp, jp, tc, jc = _exit_state()
    tc, jc = (c.replace(w_bits=bits[0], a_bits=bits[1]) for c in (tc, jc))
    b = (_jb(4), _tb(4))
    jl, je = jax.jit(lambda q: jf.exit_logits(q, jc, b[0]))(jp)
    with jitted_scales(), torch.no_grad():
        tl, te = tf.exit_logits(tp, tc, b[1])
    assert sorted(te) == sorted(je) == [1, 2]
    for g in je:
        _close(te[g], je[g], band)
    _close(tl, jl, band)
    (jv, _), jg = jax.jit(jax.value_and_grad(
        lambda q: jf.exit_loss(q, jc, b[0]), has_aux=True))(jp)
    with jitted_scales():
        tv, tg = tpasses.value_and_grad(tf.exit_loss, tc, tp, b[1])
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))
    _close_grads(tg, jg, band)
    assert float(np.abs(to_numpy(tg['blocks'][0]['attn']['wq']['w'])
                        ).max()) > 0          # the body has gradients


@pytest.mark.parametrize('bits', [(0, 0), (8, 0)])
def test_exit_stats_match_reference(bits):
    jf, tf = _families()
    tp, jp, tc, jc = _exit_state()
    tc, jc = (c.replace(w_bits=bits[0], a_bits=bits[1]) for c in (tc, jc))
    for thr in (0.025, 0.03, 0.2):
        got = tf.exit_stats(tp, tc, tf.eval_batches(2, 8), thr)
        want = jf.exit_stats(jp, jc, jf.eval_batches(2, 8), thr)
        assert got == want
        if thr < 0.1:                        # some tokens leave, not all
            assert any(0 < v < 1 for v in got[1].values())


# ------------------------------------------------------------ the chain


@pytest.fixture(scope='module')
def chains():
    """DPLQE at one step a pass (D's student three) through both
    packages' ``run_chain``: (port state, reference state)."""
    jf, tf = _families()
    tc, jc = _cfgs()
    ttr = tpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=2, eval_batch=8)
    jtr = jpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=2, eval_batch=8)
    t = tchain.run_chain(tf, tc, 'DPLQE', HPS, ttr, pretrain_steps=1)
    j = jchain.run_chain(jf, jc, 'DPLQE', HPS, jtr, pretrain_steps=1)
    return t, j


def test_dplqe_chain_matches_reference(chains):
    t, j = chains
    assert [h['pass'] for h in t.history] == \
        ['baseline', 'D', 'P', 'L', 'Q', 'E'] == \
        [h['pass'] for h in j.history]
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert (t.cfg.num_layers, t.cfg.d_ff, t.cfg.exit_layers) == \
        (2, 179, (0, 1))
    assert _ranks(to_numpy(t.params)) == _ranks(j.params) != {}
    assert [a.shape for a in tree_leaves(t.params)] == \
        [np.shape(b) for b in jax.tree.leaves(j.params)]
    for a, b in zip(t.history, j.history):
        assert (a['BitOpsCR'], a['CR']) == (b['BitOpsCR'], b['CR']), a
        assert abs(a['acc'] - b['acc']) <= 2 / (2 * 8 * SEQ), a
    assert t.exit_probs == j.exit_probs and t.exit_threshold == 0.03
    assert (t.prune_scale, t.lowrank_scale, t.base_bitops, t.base_bits) == \
        (j.prune_scale, j.lowrank_scale, j.base_bitops, j.base_bits)


def test_sweep_exit_thresholds_matches_reference(chains):
    t, j = chains
    ttr = tpasses.Trainer(eval_n=2, eval_batch=8)
    jtr = jpasses.Trainer(eval_n=2, eval_batch=8)
    thr = (0.025, 0.03, 0.5)
    got = tchain.sweep_exit_thresholds(t, ttr, thr)
    want = jchain.sweep_exit_thresholds(j, jtr, thr)
    assert [(r['threshold'], r['BitOpsCR']) for r in got] == \
        [(r['threshold'], r['BitOpsCR']) for r in want]
    for a, b in zip(got, want):
        assert abs(a['acc'] - b['acc']) <= 2 / (2 * 8 * SEQ)


# ----------------------------------------------------- checkpoints, export


def _lm_reference_state():
    """A reference LM chain state after L and E: bf16 weights, fp32 u/v
    pairs, bf16 exit heads."""
    jf, _ = _families()
    _, jc = _cfgs(dtype='bfloat16')
    p = jf.init(None, jc)
    p, jc = jf.prune(p, jc, 0.3)
    p, jc, scale = jf.factorize(p, jc, energy=0.6)
    p, jc = jf.add_exits(jax.random.key(1), p, jc, (1, 2))
    return jpasses.ChainState(
        family=jf, cfg=jc.replace(w_bits=8, a_bits=8), params=p,
        key=jax.random.fold_in(jax.random.key(3), 6), base_bitops=2.5e8,
        base_bits=1_000_000, prune_scale=1.0, lowrank_scale=scale,
        exit_probs={1: 0.25, 2: 0.5}, exit_threshold=0.8,
        dyn_accuracy=0.125,
        history=[{'pass': 'baseline', 'acc': 0.1, 'BitOpsCR': 1.0,
                  'CR': 1.0}])


def _same_state(got, want):
    assert type(got.cfg) is ModelConfig
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    for k in ('base_bitops', 'base_bits', 'prune_scale', 'lowrank_scale',
              'exit_threshold', 'dyn_accuracy', 'exit_probs', 'history'):
        assert getattr(got, k) == getattr(want, k), k


def test_reference_lm_chain_state_loads_into_the_port(tmp_path):
    want = _lm_reference_state()
    j_save_chain(str(tmp_path), want, step=5)
    _, tf = _families()
    got, step = load_chain_state(str(tmp_path), tf)
    assert step == 5
    _same_state(got, want)
    _same_tree(got.params, want.params)
    assert got.params['blocks'][0]['attn']['wq']['w'].dtype == torch.bfloat16
    assert got.params['exit_heads']['1']['adapter']['w'].dtype == \
        torch.bfloat16
    assert got.params['blocks'][0]['mlp']['wi']['u']['w'].dtype == \
        torch.float32
    data = jax.random.key_data(want.key)
    assert got.key == int(data[0]) << 32 | int(data[1])


def test_port_lm_chain_state_loads_into_the_reference(tmp_path):
    want = _lm_reference_state()
    jf, tf = _families()
    st = tpasses.ChainState(
        family=tf, cfg=ModelConfig(**dataclasses.asdict(want.cfg)),
        params=from_jax_params(want.params), key=12345,
        **{k: getattr(want, k) for k in
           ('base_bitops', 'base_bits', 'prune_scale', 'lowrank_scale',
            'exit_probs', 'exit_threshold', 'dyn_accuracy', 'history')})
    save_chain_state(str(tmp_path), st, step=5)
    got, step = j_load_chain(str(tmp_path), jf)
    assert step == 5
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    _same_tree(st.params, got.params)
    back, _ = load_chain_state(str(tmp_path), tf)
    _same_tree(back.params, got.params)
    assert back.key == 12345


def test_pipeline_export_of_an_lm_state_matches_export_lm():
    """``Pipeline.export`` of a factored, exit-headed LM state: the int8
    codes and scales of ``export_lm`` (the reference's scale shapes,
    ``u``/``v`` stacked ``(G, d, r)``/``(G, r, f)`` and the 2-D adapters
    included), and the served logits."""
    want = _lm_reference_state()
    _, tf = _families()
    st = tpasses.ChainState(family=tf,
                            cfg=ModelConfig(**dataclasses.asdict(want.cfg)),
                            params=from_jax_params(want.params), key=0,
                            exit_threshold=0.8)
    model = tchain.Pipeline.from_sequence('E').export(st, device='cpu')
    ref = j_export_lm(want.params, want.cfg)
    _same_tree(model.params, ref.params)
    wi = model.params['blocks'][0]['mlp']['wi']
    assert wi['u']['w_q'].dtype == torch.int8 and wi['u']['w_q'].dim() == 3
    G, _, r = wi['u']['w_q'].shape
    assert wi['u']['scale'].shape == (G, 1, r)
    assert model.params['exit_heads']['1']['adapter']['scale'].shape == \
        (1, 128)
    assert model.exit_threshold == 0.8 and model.backend == 'plain'
    t = _tokens(6)[0]
    f32 = st.cfg.replace(dtype='float32', a_bits=0)
    got = tfm.forward(model.params, f32, torch.from_numpy(t))
    _close(got, jtfm.forward(ref.params, want.cfg.replace(
        dtype='float32', a_bits=0), jnp.asarray(t, jnp.int32)), 1e-3)
    # the served model decodes: prefill and one step on the int8 tree
    m = build_model(f32)
    with torch.inference_mode():
        last, cache = m.prefill(model.params, {'tokens': torch.from_numpy(t)},
                                max_len=SEQ + 4)
        _close(last, got[:, -1], 1e-3)
        lg, _ = m.decode_step(model.params, torch.zeros(B, dtype=torch.long),
                              SEQ, cache)
    assert lg.shape == (B, VOCAB) and bool(torch.isfinite(lg).all())


# -------------------------------------------------- the model API device


def test_model_init_runs_on_the_card_unless_asked():
    """``Model.init`` and ``init_cache`` default to the card; with no card
    they raise rather than run on the CPU, and run there when asked."""
    m = build_model(_cfgs()[0])
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default runs there')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        m.init(gen)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        m.init_cache(1, 8)
    p = m.init(gen, 'cpu')
    assert p['embed']['table'].device.type == 'cpu'
    assert m.init_cache(1, 8, 'cpu')['blocks'][0]['k'].device.type == 'cpu'
