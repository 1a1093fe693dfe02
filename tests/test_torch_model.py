"""Model-level parity of the PyTorch port against the JAX package: the CNN
forward (fp32 and QAT fake-quant) on parameters converted through
``repro_torch.interop``, the SAME conv and GroupNorm it is built from, the
synthetic data templates, and the parameter tree layout.

Tolerance: fp32 and QAT logits within rtol 1e-5 (plus atol 1e-5 x
max|logit| for near-zero logits): XLA and torch sum conv and GroupNorm
reductions in different orders.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.cnn import MOBILENET_SMALL_CIFAR, RESNET8_CIFAR, VGG8_CIFAR
from repro.core.family import CNNFamily as JFamily
from repro.data import SyntheticImages as JImages
from repro.models import cnn as jcnn
from repro_torch.configs.cnn import CNN_REGISTRY
from repro_torch.core.family import CNNFamily
from repro_torch.data import SyntheticImages
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

CONFIGS = {'resnet': RESNET8_CIFAR, 'vgg': VGG8_CIFAR}


@functools.lru_cache(maxsize=None)
def _params(base, exits):
    fam = JFamily(JImages())
    p = jax.jit(lambda k: fam.init(k, base))(jax.random.key(0))
    cfg = base
    if exits:
        p, cfg = fam.add_exits(jax.random.key(2), p, base,
                               fam.default_exit_points(base))
    return jax.tree.map(np.asarray, p), cfg


def _x(n=2, hw=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)


@pytest.mark.parametrize('exits', [False, True])
@pytest.mark.parametrize('kind', sorted(CONFIGS))
@pytest.mark.parametrize('qat', [False, True])
def test_cnn_forward_matches_reference(kind, exits, qat):
    p, cfg = _params(CONFIGS[kind], exits)
    if qat:
        cfg = cfg.replace(w_bits=8, a_bits=8)
    x = _x()
    want = jax.jit(lambda p_, x_: jcnn.cnn_forward(
        p_, cfg, x_, collect_exits=exits))(p, x)
    got = tcnn.cnn_forward(from_jax_params(p), cfg, torch.from_numpy(x),
                           collect_exits=exits)
    if not exits:
        want, got = (want, {}), (got, {})
    (lw, ew), (lg, eg) = want, got
    assert set(ew) == set(eg)
    for a, b in [(lw, lg)] + [(ew[s], eg[s]) for s in ew]:
        a, b = np.asarray(a), b.numpy()
        scale = float(np.max(np.abs(a)))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale)


def test_stage_split_forward_equals_monolithic():
    p, cfg = _params(RESNET8_CIFAR, True)
    tp, x = from_jax_params(p), torch.from_numpy(_x())
    logits, exits = tcnn.cnn_forward(tp, cfg, x, collect_exits=True)
    h, got = x, {}
    lo = 0
    for s in cfg.exit_stages:
        seg, h = tcnn.cnn_forward(tp, cfg, h, collect_exits=True,
                                  start_stage=lo, stop_stage=s)
        got.update(seg)
        lo = s + 1
    torch.testing.assert_close(tcnn.cnn_forward(tp, cfg, h, start_stage=lo),
                               logits, rtol=0, atol=0)
    for s in exits:
        torch.testing.assert_close(got[s], exits[s], rtol=0, atol=0)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('k', [1, 3])
def test_same_conv_matches_reference(stride, k):
    """SAME at stride 2 on an even plane pads (0, 1), which F.conv2d's own
    padding cannot express; the port pads explicitly."""
    rng = np.random.default_rng(k + stride)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    p = {'w': w, 'b': np.zeros(4, np.float32)}
    want = jcnn.conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                     stride=stride)
    got = tcnn.conv(from_jax_params(p), torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_group_norm_matches_reference():
    """Population variance (correction=0), as jnp.var."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32) * 3 + 1
    p = {'scale': rng.standard_normal(16).astype(np.float32),
         'bias': rng.standard_normal(16).astype(np.float32)}
    want = jcnn.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tcnn.group_norm(from_jax_params(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_synthetic_templates_match_reference():
    np.testing.assert_array_equal(SyntheticImages().templates.numpy(),
                                  np.asarray(JImages().templates))
    x, y = SyntheticImages().batch(torch.Generator().manual_seed(0), 4)
    assert x.shape == (4, 32, 32, 3) and y.shape == (4,)
    assert bool(torch.isfinite(x).all())


def test_synthetic_batch_rolls_like_jnp_roll():
    ds = SyntheticImages()
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    x, y = ds.batch(gen, 3)
    gen.set_state(state)
    yy = torch.randint(0, ds.num_classes, (3,), generator=gen)
    shift = torch.randint(-3, 4, (3, 2), generator=gen)
    noise = torch.randn((3, 32, 32, 3), generator=gen) * ds.difficulty
    scale = 1.0 + 0.1 * torch.randn((3, 1, 1, 1), generator=gen)
    for i in range(3):
        base = np.roll(ds.templates[yy[i]].numpy(), tuple(shift[i].tolist()),
                       axis=(0, 1))
        np.testing.assert_allclose(
            x[i].numpy(), base * scale[i].numpy() + noise[i].numpy(),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('name', sorted(CNN_REGISTRY))
def test_param_tree_layout_matches_reference(name):
    """Same nested keys and shapes as the reference's init, for every
    config: trees cross through numpy with no transposes."""
    cfg = CNN_REGISTRY[name]
    if cfg.stage_widths[0] > 32:          # keep the reference init small
        cfg = cfg.replace(stage_widths=(16, 32, 64, 64, 64)[
            :len(cfg.stage_blocks)])
    fam = CNNFamily(SyntheticImages(), device='cpu')
    jfam = JFamily(JImages())
    tp, tcfg = fam.add_exits(torch.Generator().manual_seed(1),
                             fam.init(torch.Generator().manual_seed(0), cfg),
                             cfg, fam.default_exit_points(cfg))
    points = jfam.default_exit_points(cfg)
    jp = jax.eval_shape(lambda k: jfam.add_exits(
        k, jfam.init(k, cfg), cfg, points)[0], jax.random.key(0))
    assert tcfg == cfg.replace(exit_stages=points)
    shapes_t = jax.tree.map(lambda a: a.shape, to_numpy(tp))
    shapes_j = jax.tree.map(lambda a: a.shape, jp)
    assert shapes_t == shapes_j


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize('base', [RESNET8_CIFAR, MOBILENET_SMALL_CIFAR],
                         ids=lambda c: c.name)
def test_factorize_matches_reference(base):
    """Both packages split with numpy's SVD on the same weights: the same
    tree, the same ranks, factors within 1e-6, the same MAC scale.  The
    stem and MobileNet's depthwise convs stay whole."""
    p, cfg = _params(base, False)
    jp, _, jscale = JFamily(JImages()).factorize(
        jax.tree.map(jnp.asarray, p), cfg, energy=0.6, min_rank=2)
    tp, _, tscale = CNNFamily(SyntheticImages(), device='cpu').factorize(
        from_jax_params(p), cfg, energy=0.6, min_rank=2)
    want, got = dict(_walk(jax.tree.map(np.asarray, jp))), dict(
        _walk(to_numpy(tp)))
    assert set(got) == set(want)
    assert any('u' in k for k in got), 'nothing was factored'
    assert not any('u' in k for k in got if 'dw' in k or 'stem' in k)
    for k, a in want.items():
        assert got[k].shape == a.shape, k
        np.testing.assert_allclose(got[k], a, rtol=0, atol=1e-6,
                                   err_msg=str(k))
    assert tscale == pytest.approx(jscale, rel=1e-12)
    # the input tree is left as it was
    assert 'w' in from_jax_params(p)['stages'][0][0][
        'conv1' if base.kind == 'resnet' else 'expand']


@pytest.mark.parametrize('qat', [False, True])
def test_factored_forward_matches_reference(qat):
    """The forward over factored {'u', 'v'} convs and a factored head, fp32
    and QAT, within the dense forward's tolerance."""
    p, cfg = _params(RESNET8_CIFAR, True)
    p, cfg, _ = JFamily(JImages()).factorize(
        jax.tree.map(jnp.asarray, p), cfg, energy=0.6, min_rank=2)
    p = jax.tree.map(np.asarray, p)
    if qat:
        cfg = cfg.replace(w_bits=8, a_bits=8)
    x = _x()
    want = np.asarray(jax.jit(lambda p_, x_: jcnn.cnn_forward(p_, cfg, x_))(
        p, x))
    got = tcnn.cnn_forward(from_jax_params(p), cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))
