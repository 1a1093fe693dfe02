"""Training side of the port against the JAX package: AdamW, the gradient
clip and the schedule, the BitOps/CR cost model, the pass registry, the LM
family and one step of the Q pass (QAT fine-tuning).

Shared numpy inputs go through both packages; the reference's params cross
through ``repro_torch.interop``.  Tolerances, each with its reason:

* optimizer: 1e-6 relative (XLA and torch compute ``b ** step`` and the
  fp32 sums in their own ways, an ulp or two apart);
* cost model: exact (BitOpsCR and CR are analytic);
* the Q-pass step on the 2-layer fp32 smoke tinyllama: the loss within
  1e-5 relative and every gradient leaf within 1e-5 x its max|g| (the
  matmuls sum in other orders); the updated params no element more than
  0.25 x lr apart and at most 0.1% of elements more than 1e-2 x lr apart
  (AdamW's first step is ``g / (|g| + eps)`` times lr, about +-lr whatever
  |g| is, so a gradient within float noise of 0 moves its element by up to
  lr either way; weights and activations are fake-quantized in both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import REGISTRY as J_ARCHS
from repro.configs import cnn as jcnn
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import bitops as jbo
from repro.core import family as jfamily
from repro.core import passes as jpasses
from repro.core import registry as jregistry
from repro.data import SyntheticTokens as JTokens
from repro.models import build_model as j_build_model
from repro_torch import optim as toptim
from repro_torch.configs import cnn as tcnn
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import bitops as tbo
from repro_torch.core import family as tfamily
from repro_torch.core import passes as tpasses
from repro_torch.core import registry as tregistry
from repro_torch.data import SyntheticTokens
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCH = 'tinyllama-1.1b'
B, S, LR = 2, 16, 1e-3


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


# ------------------------------------------------------------- optimizer


def _opt_trees(seed, n_grads):
    """A param tree (fp32 and bf16 leaves, a stacked one, a list) and
    ``n_grads`` grad trees, as numpy."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {'b': {'w': rng.standard_normal((3, 8, 5)) * scale,
                      'scale': 1 + rng.standard_normal(5) * scale},
                'a': [rng.standard_normal((4, 6)) * scale],
                'h': rng.standard_normal((7,)) * scale}

    def cast(t):
        t = jax.tree.map(lambda a: a.astype(np.float32), t)
        t['h'] = np.asarray(jnp.asarray(t['h']).astype(jnp.bfloat16))
        return t
    return cast(tree(1.0)), [cast(tree(0.1)) for _ in range(n_grads)]


@pytest.mark.parametrize('n_updates', [1, 3])
@pytest.mark.parametrize('weight_decay', [0.0, 1e-2])
def testoptim_matches_reference(n_updates, weight_decay):
    params, grads = _opt_trees(n_updates, n_updates)
    jopt = joptim.adamw(LR, weight_decay=weight_decay)
    topt = toptim.adamw(LR, weight_decay=weight_decay)
    jp, tp = jax.tree.map(jnp.asarray, params), from_jax_params(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(from_jax_params(g), ts, tp)
        jp = joptim.apply_updates(jp, ju)
        tp = toptim.apply_updates(tp, tu)
    assert int(ts.step) == int(js.step) == n_updates
    for want, got in zip(jax.tree.leaves((js.mu, js.nu, ju)),
                         tree_leaves(to_numpy((ts.mu, ts.nu, tu)))):
        _close(got, want, 1e-6)
    for want, got in zip(jax.tree.leaves(jp), tree_leaves(to_numpy(tp))):
        assert got.dtype == np.asarray(want).dtype
        # a bf16 leaf rounds its update: one bf16 ulp at most
        _close(got, want, 1e-6 if got.dtype == np.float32 else 2 ** -7)


@pytest.mark.parametrize('max_norm', [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, (g,) = _opt_trees(5, 1)
    want, wn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                           max_norm)
    got, tn = toptim.clip_by_global_norm(from_jax_params(g), max_norm)
    _close(tn.numpy(), wn, 1e-6)
    for w, t in zip(jax.tree.leaves(want), tree_leaves(to_numpy(got))):
        _close(t, w, 1e-6)


def test_cosine_schedule_matches_reference():
    want = joptim.cosine_schedule(3e-3, 100, warmup=10)
    got = toptim.cosine_schedule(3e-3, 100, warmup=10)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        _close(float(got(step)), float(want(step)), 1e-6)


# ------------------------------------------------------------ cost model


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize('arch', sorted(J_ARCHS))
def test_lm_bitops_match_reference(arch):
    """Every reference architecture (MoE, MLA, recurrent and SSM blocks
    included: the cost model covers what the models do not yet), full and
    smoke size, quantized or not, prefill, decode and with exit
    probabilities."""
    for jcfg in (J_ARCHS[arch], j_get_smoke_config(arch)):
        for bits in ((0, 0), (8, 8), (4, 8)):
            jc = jcfg.replace(w_bits=bits[0], a_bits=bits[1])
            tc = _port_cfg(jc)
            assert tbo.lm_bitops(tc, 128) == jbo.lm_bitops(jc, 128)
            assert tbo.lm_bitops(tc, 128, decode=True, ctx_len=512) == \
                jbo.lm_bitops(jc, 128, decode=True, ctx_len=512)
            ep = {0: 0.25, jc.num_layers - 1: 0.5}
            assert tbo.lm_bitops(tc, 64, exit_probs=ep) == \
                jbo.lm_bitops(jc, 64, exit_probs=ep)
            assert tbo.lm_layer_macs(tc, 32) == jbo.lm_layer_macs(jc, 32)


@pytest.mark.parametrize('name', sorted(jcnn.CNN_REGISTRY))
def test_cnn_bitops_match_reference(name):
    jc = jcnn.CNN_REGISTRY[name]
    tc = tcnn.CNN_REGISTRY[name]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for bits in ((0, 0), (8, 8), (2, 4)):
        jq_, tq_ = (c.replace(w_bits=bits[0], a_bits=bits[1])
                    for c in (jc, tc))
        assert tbo.cnn_stage_macs(tq_) == jbo.cnn_stage_macs(jq_)
        assert tbo.cnn_bitops(tq_) == jbo.cnn_bitops(jq_)
        ep = {0: 0.3, len(jc.stage_blocks) - 2: 0.4}
        assert tbo.cnn_bitops(tq_, 32, exit_probs=ep) == \
            jbo.cnn_bitops(jq_, 32, exit_probs=ep)


def test_param_storage_bits_match_reference():
    params, _ = _opt_trees(0, 0)
    for bits in (0, 8, 4):
        assert tbo.param_storage_bits(from_jax_params(params), bits) == \
            jbo.param_storage_bits(params, bits)
    assert tbo.compression_summary(10.0, 8, 2.5, 2) == \
        jbo.compression_summary(10.0, 8, 2.5, 2)


# -------------------------------------------------------------- registry


def test_registry_resolves_hps_as_the_reference():
    tq_, jq_ = tregistry.get_pass('Q'), jregistry.get_pass('Q')
    assert (tq_.key, tq_.name, tq_.kind, tq_.granularity, tq_.rank) == \
        (jq_.key, jq_.name, jq_.kind, jq_.granularity, jq_.rank)
    for hp in (None, {'w_bits': 4}, {'w_bits': 2, 'a_bits': 4}):
        assert dataclasses.asdict(tq_.resolve_hp(hp)) == \
            dataclasses.asdict(jq_.resolve_hp(hp))
    typed = tpasses.QuantHP(w_bits=4)
    assert tq_.resolve_hp(typed) is typed
    with pytest.raises(TypeError, match='w_bit'):
        tq_.resolve_hp({'w_bit': 4})
    with pytest.raises(TypeError):
        tq_.resolve_hp(8)
    assert tregistry.check_consistency() == ('D', 'E', 'L', 'P', 'Q')


def test_registry_register_and_unregister():
    @dataclasses.dataclass(frozen=True)
    class HP:
        x: int = 1

    seen = []
    p = tregistry.CompressionPass(
        'Z', 'probe', 'dynamic', 'neuron', HP,
        lambda state, hp, trainer: seen.append(hp.x) or state)
    tregistry.register(p)
    try:
        with pytest.raises(ValueError, match='already registered'):
            tregistry.register(p)
        assert tregistry.register(p, replace=True) is p
        assert tregistry.get_pass('Z').apply('state', {'x': 3}, None) == \
            'state'
        assert seen == [3]
        assert tregistry.registered_keys() == ('D', 'E', 'L', 'P', 'Q', 'Z')
    finally:
        assert tregistry.unregister('Z') is p
    with pytest.raises(KeyError):
        tregistry.get_pass('Z')
    for bad in (dataclasses.replace(p, key='zz'),
                dataclasses.replace(p, kind='sometimes'),
                dataclasses.replace(p, granularity='atom'),
                dataclasses.replace(p, hp_cls=dict)):
        with pytest.raises(ValueError):
            tregistry.register(bad)
    assert tregistry.registered_keys() == ('D', 'E', 'L', 'P', 'Q')


# ------------------------------------------- LM family and the Q pass step


class _JFixed(jfamily.LMFamily):
    """The reference's family, every training batch the given one."""
    fixed = None

    def train_batch(self, key, n):
        return self.fixed


class _TFixed(tfamily.LMFamily):
    fixed = None

    def train_batch(self, gen, n):
        return self.fixed


@pytest.fixture(scope='module')
def lm():
    """(reference cfg, port cfg, reference params, numpy batch)."""
    jcfg = j_get_smoke_config(ARCH, layers=2)
    cfg = get_smoke_config(ARCH, layers=2)
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.key(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(B, S + 1))
    return jcfg, cfg, jp, {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}


def _families(lm):
    jcfg, cfg, _, nb = lm
    jf = _JFixed(JTokens(jcfg.vocab_size), seq=S)
    tf = _TFixed(SyntheticTokens(cfg.vocab_size), seq=S, device='cpu')
    jf.fixed = {k: jnp.asarray(v.astype(np.int32)) for k, v in nb.items()}
    tf.fixed = {k: torch.from_numpy(v.astype(np.int64))
                for k, v in nb.items()}
    return jf, tf


def test_lm_family_matches_reference(lm):
    jcfg, cfg, jp, _ = lm
    jf, tf = _families(lm)
    tp = from_jax_params(jp)
    for bits in (0, 8):
        jc, tc = (c.replace(w_bits=bits, a_bits=bits) for c in (jcfg, cfg))
        jl, jlg = jf.loss(jp, jc, jf.fixed)
        tl, tlg = tf.loss(tp, tc, tf.fixed)
        _close(tlg.detach().numpy(), jlg, 1e-5)
        _close(float(tl), float(jl), 1e-5)
        assert tf.accuracy(tp, tc, [tf.fixed]) == \
            jf.accuracy(jp, jc, [jf.fixed])
        assert tf.bitops(tc) == jf.bitops(jc)
        assert tf.bitops(tc, {0: 0.5}, 0.5) == jf.bitops(jc, {0: 0.5}, 0.5)
        assert tf.storage_bits(tp, tc) == jf.storage_bits(jp, jc)
    batches = tf.eval_batches(2, 3)
    assert [tuple(b['tokens'].shape) for b in batches] == [(3, S)] * 2
    assert torch.equal(batches[0]['tokens'][:, 1:],
                       batches[0]['labels'][:, :-1])
    assert tf.prune(tp, cfg, 0.3)[1].d_ff == jf.prune(jp, jcfg, 0.3)[1].d_ff


def test_q_pass_step_matches_reference(lm):
    """One Q-pass step through the registry on the same batch: the loss and
    the gradients at the quantized config, then the fine-tuned params."""
    jcfg, cfg, jp, _ = lm
    jf, tf = _families(lm)
    tp = from_jax_params(jp)
    jc, tc = (c.replace(w_bits=8, a_bits=8) for c in (jcfg, cfg))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jf.loss(p, jc, jf.fixed), has_aux=True))(jp)
    tl, tg = tpasses.value_and_grad(tf.loss, tc, tp, tf.fixed)
    _close(float(tl), float(jl), 1e-5)
    for want, got in zip(jax.tree.leaves(jg), tree_leaves(to_numpy(tg))):
        _close(got, want, 1e-5)

    hp = {'w_bits': 8, 'a_bits': 8}
    jtr = jpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=1, eval_batch=B)
    ttr = tpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=1, eval_batch=B)
    jst = jregistry.get_pass('Q').apply(jpasses.ChainState(
        family=jf, cfg=jcfg, params=jp, key=jax.random.key(0)), hp, jtr)
    tst = tregistry.get_pass('Q').apply(tpasses.ChainState(
        family=tf, cfg=cfg, params=tp, key=0), hp, ttr)
    assert (tst.cfg.w_bits, tst.cfg.a_bits) == (8, 8)
    lr = LR / 10                          # Q fine-tunes at lr / 10
    moved = 0
    for want, got, before in zip(jax.tree.leaves(jst.params),
                                 tree_leaves(to_numpy(tst.params)),
                                 jax.tree.leaves(jp)):
        d = np.abs(got - np.asarray(want))
        assert float(d.max()) <= 0.25 * lr
        assert float((d > 1e-2 * lr).mean()) <= 1e-3
        moved += int((got != np.asarray(before)).sum())
    assert moved > 0
    assert tst.key == tpasses.fold_in(0, 4)


def test_chain_state_metrics_and_train_keys(lm):
    """``init_chain_state`` -> Q -> ``metrics``: the path the chain runs,
    cut to Q.  BitOpsCR and CR are analytic (32x32 -> 8x8 bits: 16x; 32
    -> 8 bits a weight: 4x); ``train_keys`` masks the other gradients, so
    those params move only by weight decay."""
    _, cfg, _, _ = lm
    fam = tfamily.LMFamily(SyntheticTokens(cfg.vocab_size), seq=S,
                           device='cpu')
    tr = tpasses.Trainer(batch=B, steps=1, lr=LR, eval_n=1, eval_batch=B)
    st = tpasses.init_chain_state(fam, cfg, 0, tr, pretrain_steps=0)
    assert st.key == tpasses.fold_in(0, 777)
    st = tregistry.get_pass('Q').apply(st, {'w_bits': 8, 'a_bits': 8}, tr)
    rec = st.metrics(tr, 'Q')
    assert [h['pass'] for h in st.history] == ['baseline', 'Q']
    assert (rec['BitOpsCR'], rec['CR']) == (16.0, 4.0)
    assert 0.0 <= rec['acc'] <= 1.0

    mask = tpasses.mask_like(st.params, lambda k: k == 'embed')
    assert float(mask['embed']['table']) == 1.0
    assert float(tree_leaves(mask['blocks'])[0]) == 0.0
    new, loss = tr.fit(fam, st.cfg, st.params, train_keys={'embed'}, lr=LR,
                       steps=1)
    assert np.isfinite(loss)
    wd_only = st.params['final_norm']['scale'] * (1 - LR * tr.weight_decay)
    torch.testing.assert_close(new['final_norm']['scale'], wd_only,
                               rtol=1e-6, atol=0)
    assert not torch.equal(new['embed']['table'], st.params['embed']['table'])
    # Q after E re-measures the exit statistics at E's threshold
    p, c = fam.add_exits(fam.generator(1), st.params, st.cfg, (0,))
    after = tregistry.get_pass('Q').apply(dataclasses.replace(
        st, params=p, cfg=c, exit_probs={0: 0.5}, exit_threshold=0.01),
        None, tr)
    assert after.exit_threshold == 0.01 and set(after.exit_probs) == {0}
    assert (after.dyn_accuracy, after.exit_probs) == fam.exit_stats(
        after.params, after.cfg, fam.eval_batches(1, B), 0.01)
