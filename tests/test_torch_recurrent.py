"""Parity of the port's recurrent LM blocks against the JAX package:
recurrentgemma-9b (RG-LRU layers and MQA local-attention layers) and
mamba2-2.7b (Mamba-2's SSD), on each arch's smoke config (``reduced``:
d_model 128, fp32; RG-LRU width 128; SSD state 16, head dim 16, chunk 32)
and on narrow configs with every structural field of the published ones;
the causal conv, the linear scan, the gradient compressor and the decode
kernel's plan at recurrentgemma's group of 16 at head_dim 256.

One reference build per arch (module scope); its params cross through
``repro_torch.interop`` and the same numpy inputs go through both.  Every
reference function runs under ``jax.jit``, and the port's QAT scales under
``quantization.jitted_scales``.  Tolerances:

* outputs, states and logits within 1e-5 x max|.| (XLA and torch sum in
  other orders); ``linear_scan`` bit for bit against
  ``jax.lax.associative_scan``; SSD's output from
  bf16 B and C within 8e-3 (``C . B`` rounds to bf16 in both); an int8-KV step
  whose cache holds a code one step apart at a rounding tie within 1e-3
  (tests/test_torch_archs.py);
* int8 codes and scales, pruned trees, ranks, BitOps, configs and the
  gradient compressor's codes, scales and residuals: bit for bit.

About 60 s on one CPU core.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import bitops as j_bitops
from repro.core import chain as jchain
from repro.core import family as jfamily
from repro.core import passes as jpasses
from repro.core.export import export_lm as j_export_lm
from repro.data import SyntheticTokens as JTokens
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import layers as jlayers
from repro.models import recurrent as jrec
from repro.models import transformer as jtfm
from repro.optim.compression import int8_compress_grads as j_compress
from repro.optim.compression import int8_decompress as j_decompress
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core import bitops
from repro_torch.core import chain as tchain
from repro_torch.core import family as tfamily
from repro_torch.core import passes as tpasses
from repro_torch.core.export import export_lm
from repro_torch.core.quantization import jitted_scales
from repro_torch.data import SyntheticTokens
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.tiling import SMEM_BUDGET
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model, param_count
from repro_torch.optim import int8_compress_grads
from repro_torch.optim.compression import int8_decompress
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = ('recurrentgemma-9b', 'mamba2-2.7b')
B, S, STEPS = 2, 12, 3
TOL = 1e-5
CODE_FLIP_TOL = 1e-3
# SSD's C . B stays in bf16 for bf16 B and C in both packages, and an fp32
# sum that differs in its last bit between XLA and torch can round to the
# neighbouring bf16 value (2**-8 relative): y within about one bf16 ulp
BF16_TOL = 8e-3


def _cfgs(name, **kw):
    """(reference config, port config): the arch's smoke config."""
    return (j_get_smoke_config(name).replace(**kw),
            get_smoke_config(name).replace(**kw))


def _narrow(name):
    """A narrow config with every structural field of the published one:
    recurrentgemma's (rec, rec, local) groups and a recurrent tail layer,
    MQA, the tied embedding; mamba2's 4 SSD layers with state, head dim
    and chunk of its own, an untied embedding."""
    kw = dict(d_model=64, vocab_size=64, window=16)
    if name == 'recurrentgemma-9b':
        kw.update(num_layers=8, num_heads=4, head_dim=16, d_ff=96,
                  rglru_width=48)
    else:
        kw.update(num_layers=4, ssm_state=8, ssm_headdim=16, ssm_chunk=8)
    return j_get_config(name).replace(**kw), get_config(name).replace(**kw)


@functools.lru_cache(maxsize=None)
def _params(name):
    jcfg, _ = _cfgs(name)
    p = jax.jit(j_build_model(jcfg).init)(jax.random.key(0))
    return jax.tree.map(np.asarray, p)


def _build(name, **kw):
    """(JAX model, JAX params, port model, port params) of an arch's smoke
    config; the params do not depend on the cache bits."""
    jcfg, cfg = _cfgs(name, **kw)
    jp = _params(name)
    return (j_build_model(jcfg), jax.tree.map(jnp.asarray, jp),
            build_model(cfg), from_jax_params(jp))


def _tokens(cfg, n=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(n, s)).astype(np.int32)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    assert _rel(got, want) <= tol


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _same_tree(got, want):
    """Bit for bit: the same leaves in the same order, shapes, dtypes and
    values."""
    got = jax.tree_util.tree_flatten_with_path(to_numpy(got))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(b).view(np.uint8))


def _code_flips(jc, tc):
    """Int8 cache codes that differ between the two caches: each one step
    apart, fewer than 1e-3 of the codes."""
    n = tot = 0
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    tree_leaves(to_numpy(tc))):
        if a.dtype == np.int8:
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1
            n, tot = n + int((d > 0).sum()), tot + d.size
    assert n <= 1e-3 * max(tot, 1), (n, tot)
    return n


def _caches_close(jc, tc, tol=TOL):
    """Every float leaf of the two caches within ``tol`` x its max (the
    recurrent states ``h`` and ``conv`` among them), the int32 positions
    equal; int8 codes by :func:`_code_flips`."""
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jc))
    tl = tree_leaves(to_numpy(tc))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, a)
        elif a.dtype != np.int8 and np.abs(a).max() > 0:
            assert _rel(b, a) <= tol


# ------------------------------------------------------------ configs


@pytest.mark.parametrize('name', ARCHS)
def test_configs_match_reference(name):
    assert name in ARCH_NAMES
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(get_smoke_config(name)) == \
        dataclasses.asdict(j_get_smoke_config(name))


@pytest.mark.parametrize('name', ARCHS)
@pytest.mark.parametrize('bits', [(0, 0), (8, 8), (4, 8)])
def test_bitops_of_the_published_configs_match_reference(name, bits):
    """BitOps count the RG-LRU's and SSD's projections, the conv and the
    SSD scan's terms at a prompt and at one token, with and without exits;
    the storage bits of a tree."""
    tc = get_config(name).replace(w_bits=bits[0], a_bits=bits[1])
    jc = j_get_config(name).replace(w_bits=bits[0], a_bits=bits[1])
    for seq in (1, 128, 4096):
        assert bitops.lm_bitops(tc, seq) == j_bitops.lm_bitops(jc, seq)
    ep = {3: 0.25, 10: 0.5}
    assert bitops.lm_bitops(tc, 128, exit_probs=ep) == \
        j_bitops.lm_bitops(jc, 128, exit_probs=ep)
    p = _params(name)
    assert bitops.param_storage_bits(from_jax_params(p), 8) == \
        j_bitops.param_storage_bits(p, 8)


def test_build_model_builds_every_arch_of_the_reference():
    for name in ARCH_NAMES:
        assert build_model(get_config(name)).cfg.name == name
    assert {'recurrent', 'ssm'} <= {k for n in ARCH_NAMES
                                    for k in get_config(n).layer_kinds()}


def test_init_layer_refuses_a_kind_the_reference_lacks():
    """``_init_layer`` raises ValueError for a block kind the reference
    does not have, as the reference's does."""
    _, cfg = _cfgs('recurrentgemma-9b')
    with pytest.raises(ValueError, match='conv'):
        tfm._init_layer(torch.Generator(), cfg, 'conv', moe_layer=False,
                        dtype=torch.float32, device='cpu')


# ------------------------------------------------- param and cache trees


@pytest.mark.parametrize('shape', ['smoke', 'narrow'])
@pytest.mark.parametrize('name', ARCHS)
def test_param_and_cache_trees_match_reference(name, shape):
    """The port's init and init_cache give the reference's trees, shapes
    and dtypes (``jax.eval_shape``): RG-LRU's ``lam`` in the model's
    dtype, SSD's ``A_log``/``D``/``dt_bias`` fp32 in a bf16 model, a
    mamba layer with no MLP and no ``norm2``; the caches' ``h`` fp32 and
    their conv states in the model's dtype, recurrentgemma's local layer
    an int8 cache at kv_cache_bits 8 and the recurrent states not."""
    jcfg, cfg = _cfgs(name) if shape == 'smoke' else _narrow(name)
    for dtype, kv in (('float32', 0), ('bfloat16', 8)):
        jc, tc = (c.replace(dtype=dtype, kv_cache_bits=kv)
                  for c in (jcfg, cfg))
        jp = jax.eval_shape(j_build_model(jc).init, jax.random.key(0))
        tp = build_model(tc).init(torch.Generator().manual_seed(0), 'cpu')
        jcache = jax.eval_shape(lambda: jtfm.init_cache(jc, B, 20))
        tcache = build_model(tc).init_cache(B, 20, 'cpu')
        for j, t in ((jp, tp), (jcache, tcache)):
            jl = jax.tree_util.tree_flatten_with_path(j)[0]
            tl = jax.tree_util.tree_flatten_with_path(to_numpy(t))[0]
            assert [p for p, _ in jl] == [p for p, _ in tl]
            for (_, a), (_, b) in zip(jl, tl):
                assert tuple(a.shape) == b.shape and a.dtype == b.dtype
        assert param_count(tp) == sum(
            a.size for a in jax.tree.leaves(jp))
        lp = tp['blocks'][0]
        if name == 'mamba2-2.7b':
            assert set(lp) == {'norm1', 'mamba'}
            assert lp['mamba']['A_log'].dtype == torch.float32
            assert tcache['blocks'][0]['h'].dtype == torch.float32
        else:
            assert lp['rglru']['lam'].dtype == tfm.torch_dtype(dtype)
            assert 'mlp' in lp and 'norm2' in lp
            int8 = [a for a in tree_leaves(tcache) if a.dtype == torch.int8]
            assert bool(int8) == bool(kv) and len(int8) == 2 * bool(kv)


# ------------------------------------------------ the conv and the scan


@pytest.mark.parametrize('k,C', [(4, 24), (2, 5)])
def test_causal_conv_and_its_step_match_reference(k, C):
    """``causal_conv1d`` over a sequence and ``conv1d_step`` over the same
    inputs one at a time from a zero state: each against the reference's
    within 1e-5 x max, and the steps equal to the sequence's rows."""
    p = {'w': _rand((k, C), 1), 'b': _rand((C,), 2)}
    x = _rand((B, 9, C), 3)
    want = jax.jit(jlayers.causal_conv1d)(p, x)
    tp = from_jax_params(p)
    got = layers.causal_conv1d(tp, torch.from_numpy(x))
    _close(got, want)
    state = np.zeros((B, k - 1, C), np.float32)
    jstate, tstate = jnp.asarray(state), torch.from_numpy(state)
    jstep = jax.jit(jlayers.conv1d_step)
    for t in range(x.shape[1]):
        jy, jstate = jstep(p, x[:, t], jstate)
        ty, tstate = layers.conv1d_step(tp, torch.from_numpy(x[:, t]),
                                        tstate)
        _close(ty, jy)
        _close(ty, got[:, t].numpy())
        _close(tstate, jstate)


@pytest.mark.parametrize('n', [1, 7, 32, 512, 513])
def test_linear_scan_matches_associative_scan(n):
    """``h_t = a_t h_{t-1} + b_t`` with a in [0.5, 1): the port's doubling
    scan against ``jax.lax.associative_scan`` of the reference's combine,
    at odd and power-of-two lengths, and with ``a`` broadcast over
    trailing axes (SSD's inter-chunk form)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 16)).astype(np.float32)
    b = rng.standard_normal((2, n, 16)).astype(np.float32)

    def combine(l, r):
        (al, bl), (ar, br) = l, r
        return al * ar, ar * bl + br
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1)[1])(a, b)
    _close(rec.linear_scan(torch.from_numpy(a), torch.from_numpy(b)), want)
    b4 = rng.standard_normal((2, n, 16, 3, 2)).astype(np.float32)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1)[1])(
            np.broadcast_to(a[..., None, None], b4.shape), b4)
    _close(rec.linear_scan(torch.from_numpy(a)[..., None, None],
                           torch.from_numpy(b4)), want)


@pytest.mark.parametrize('n', [2, 7, 32, 513])
def test_linear_scan_rounds_as_associative_scan(n):
    """The port's scan combines in ``jax.lax.associative_scan``'s order
    with its multiply-adds fused as XLA fuses them: the states equal the
    reference's bit for bit, with ``a`` whole and broadcast."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 16)).astype(np.float32)
    b = rng.standard_normal((2, n, 16, 3, 2)).astype(np.float32)

    def combine(l, r):
        (al, bl), (ar, br) = l, r
        return al * ar, ar * bl + br
    scan = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1)[1])
    want = np.asarray(scan(a, b[..., 0, 0]))
    got = rec.linear_scan(torch.from_numpy(a), torch.from_numpy(b[..., 0, 0]))
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(scan(np.broadcast_to(a[..., None, None], b.shape), b))
    got = rec.linear_scan(torch.from_numpy(a)[..., None, None],
                          torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)

# ------------------------------------------------------------- RG-LRU


@functools.lru_cache(maxsize=None)
def _rglru_case():
    jcfg, cfg = _cfgs('recurrentgemma-9b')
    p = jax.jit(functools.partial(jrec.init_rglru, cfg=jcfg))(
        jax.random.key(3))
    # lam spread around its init so that the decays differ by channel
    p = dict(p, lam=p['lam'] + jnp.asarray(_rand((cfg.rglru_width,), 4)))
    return jcfg, cfg, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize('quant', [(0, 0), (8, 8)])
def test_rglru_gates_forward_and_decode_match_reference(quant):
    """``_rglru_gates``, ``rglru_forward`` (and its state) and three
    ``rglru_decode`` steps continuing from it, at full precision and W8A8
    fake quant."""
    jcfg, cfg, p = _rglru_case()
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_params(p)
    x = _rand((B, S, cfg.d_model), 5)
    u = _rand((B, S, cfg.rglru_width), 6)
    ja, jb = jax.jit(functools.partial(jrec._rglru_gates, quant=quant))(
        jp, u)
    with jitted_scales(), torch.no_grad():
        ta, tb = rec._rglru_gates(tp, torch.from_numpy(u), quant)
        tout, state = rec.rglru_forward(tp, torch.from_numpy(x), cfg,
                                        quant=quant, return_state=True)
    _close(ta, ja)
    _close(tb, jb)
    want = jax.jit(functools.partial(jrec.rglru_forward, cfg=jcfg,
                                     quant=quant))(jp, x)
    _close(tout, want)
    # the reference's prefill state: the scan's last row and the conv's
    # last k - 1 inputs
    jh = jax.jit(lambda p, x: jax.lax.associative_scan(
        lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]),
        jrec._rglru_gates(p, jlayers.causal_conv1d(
            p['conv'], jlayers.dense(p['wx'], x, quant=quant)), quant),
        axis=1)[1][:, -1])(jp, x)
    _close(state['h'], jh)
    _close(state['conv'], np.asarray(jax.jit(lambda p, x: jlayers.dense(
        p['wx'], x, quant=quant))(jp, x))[:, -3:])
    jcache = {'h': jnp.asarray(state['h'].numpy()),
              'conv': jnp.asarray(state['conv'].numpy())}
    tcache = {k: v.clone() for k, v in state.items()}
    jstep = jax.jit(functools.partial(jrec.rglru_decode, cfg=jcfg,
                                      quant=quant))
    for t in range(STEPS):
        xt = _rand((B, cfg.d_model), 10 + t)
        jo, jcache = jstep(jp, xt, jcache)
        with jitted_scales(), torch.no_grad():
            to, tcache = rec.rglru_decode(tp, torch.from_numpy(xt), tcache,
                                          cfg, quant=quant)
        _close(to, jo)
        _close(tcache['h'], jcache['h'])
        _close(tcache['conv'], jcache['conv'])


# ---------------------------------------------------------------- SSD


@pytest.mark.parametrize('l,chunk', [(64, 32), (20, 32), (40, 32)],
                         ids=['two-chunks', 'below-a-chunk', 'padded'])
def test_ssd_chunked_matches_reference(l, chunk):
    """``ssd_chunked`` at a multiple of the chunk (two chunks: the
    inter-chunk scan), below it (one chunk of l), and on a sequence
    zero-padded to the next multiple (a = 0, x = B = C = 0 on the pad):
    y[:l] and the final state unchanged by the pad.  bf16 B and C beside
    fp32 decays, as a bf16 model gives them, promote to fp32 as in JAX."""
    b, h, p, n = 2, 3, 4, 5
    x = _rand((b, l, h, p), 1)
    a = -np.abs(_rand((b, l, h), 2, 0.3))
    Bm, Cm = _rand((b, l, n), 3), _rand((b, l, n), 4)
    pad = (-l) % min(chunk, l)
    args = [np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
            for v in (x, a, Bm, Cm)]
    fn = jax.jit(functools.partial(jrec.ssd_chunked, chunk=chunk))
    jy, js = fn(*args)
    ty, ts = rec.ssd_chunked(*(torch.from_numpy(v) for v in args), chunk)
    _close(ty, jy)
    _close(ts, js)
    if pad:     # as one chunk of l gives them
        jy1, js1 = jax.jit(functools.partial(jrec.ssd_chunked, chunk=l))(
            x, a, Bm, Cm)
        _close(ty[:, :l], jy1)
        _close(ts, js1)
    bf = [torch.from_numpy(v) for v in args]
    bf[2], bf[3] = bf[2].bfloat16(), bf[3].bfloat16()
    jb = [jnp.asarray(v) for v in args]
    jb[2], jb[3] = jb[2].astype(jnp.bfloat16), jb[3].astype(jnp.bfloat16)
    jy, js = fn(*jb)
    ty, ts = rec.ssd_chunked(*bf, chunk)
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    _close(ty, jy, BF16_TOL)
    _close(ts, js)


@functools.lru_cache(maxsize=None)
def _mamba_case():
    jcfg, cfg = _cfgs('mamba2-2.7b')
    p = jax.jit(functools.partial(jrec.init_mamba2, cfg=jcfg))(
        jax.random.key(3))
    h = p['A_log'].shape[0]
    p = dict(p, A_log=jnp.asarray(_rand((h,), 4, 0.5)),
             dt_bias=jnp.asarray(_rand((h,), 5, 0.5)),
             D=jnp.asarray(_rand((h,), 6)))
    return jcfg, cfg, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize('s', [12, 64, 40], ids=['one-chunk', 'two-chunks',
                                                 'padded'])
@pytest.mark.parametrize('quant', [(0, 0), (8, 8)])
def test_mamba2_forward_and_decode_match_reference(s, quant):
    """``mamba2_forward(return_state=True)`` (the output, the final SSD
    state and the conv tail) at one chunk, two chunks and a padded second
    chunk, then three ``mamba2_decode`` steps continuing from its state."""
    jcfg, cfg, p = _mamba_case()
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_params(p)
    x = _rand((B, s, cfg.d_model), 7)
    jo, (jst, jtail) = jax.jit(functools.partial(
        jrec.mamba2_forward, cfg=jcfg, quant=quant, return_state=True))(
            jp, x)
    with jitted_scales(), torch.no_grad():
        to, (tst, ttail) = rec.mamba2_forward(
            tp, torch.from_numpy(x), cfg, quant=quant, return_state=True)
    _close(to, jo)
    _close(tst, jst)
    _close(ttail, jtail)
    jcache = {'h': jst, 'conv': jtail}
    tcache = {'h': tst.clone(), 'conv': ttail.clone()}
    jstep = jax.jit(functools.partial(jrec.mamba2_decode, cfg=jcfg,
                                      quant=quant))
    for t in range(STEPS):
        xt = _rand((B, cfg.d_model), 20 + t)
        jo, jcache = jstep(jp, xt, jcache)
        with jitted_scales(), torch.no_grad():
            to, tcache = rec.mamba2_decode(tp, torch.from_numpy(xt), tcache,
                                           cfg, quant=quant)
        _close(to, jo)
        _close(tcache['h'], jcache['h'])
        _close(tcache['conv'], jcache['conv'])


# ---------------------------------------------------------- the whole model


@pytest.mark.parametrize('name', ARCHS)
def test_forward_and_exit_hiddens_match_reference(name):
    """Logits, and ``collect_hiddens``: the residual stream after each scan
    group, the exit heads' inputs."""
    jm, jp, tm, tp = _build(name)
    toks = _tokens(tm.cfg, s=40)
    want = jax.jit(jm.forward)(jp, {'tokens': toks})
    jl, jh = jax.jit(functools.partial(jm.forward, collect_hiddens=True))(
        jp, {'tokens': toks})
    with torch.inference_mode():
        got = tm.forward(tp, {'tokens': torch.from_numpy(toks).long()})
        tl, th = tm.forward(tp, {'tokens': torch.from_numpy(toks).long()},
                            collect_hiddens=True)
    _close(got.numpy(), want)
    assert len(th) == jh.shape[0] == tfm.layer_groups(tm.cfg)[1]
    for g in range(len(th)):
        _close(th[g].numpy(), jh[g])


@pytest.mark.parametrize('name,kv_bits', [('recurrentgemma-9b', 0),
                                          ('recurrentgemma-9b', 8),
                                          ('mamba2-2.7b', 0)])
def test_prefill_and_decode_match_reference(name, kv_bits):
    """Prefill logits and the whole cache (the recurrent states ``h`` and
    ``conv`` beside the local layer's k/v), then STEPS decode steps, each
    step's logits and cache against the reference's.  The prompt of 40
    runs mamba2's SSD as one chunk of 32 and a padded second one."""
    jm, jp, tm, tp = _build(name, kv_cache_bits=kv_bits)
    toks = _tokens(tm.cfg, s=40)
    s = toks.shape[1]
    max_len = s + STEPS + 4
    jl, jc = jax.jit(functools.partial(jm.prefill, max_len=max_len))(
        jp, {'tokens': toks})
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {'tokens': torch.from_numpy(toks).long()},
                            max_len=max_len)
    _close(tl.numpy(), jl)
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == \
        jax.tree.structure(to_numpy(tc))
    int8 = [a for a in tree_leaves(tc) if a.dtype == torch.int8]
    assert bool(int8) == bool(kv_bits)
    flips = _code_flips(jc, tc) if int8 else 0
    _caches_close(jc, tc)
    jstep = jax.jit(jm.decode_step)
    tok = np.array([7, 11], np.int32)
    for t in range(STEPS):
        jl, jc = jstep(jp, tok, jnp.asarray(s + t, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), s + t,
                                    tc)
        flips = _code_flips(jc, tc) if int8 else 0
        _close(tl.numpy(), jl, CODE_FLIP_TOL if flips else TOL)
        _caches_close(jc, tc, CODE_FLIP_TOL if flips else TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_first_step_sensitivity_moves_the_plain_step():
    """chip_smoke's first-step sensitivity (the guard of its first-step
    gate) on recurrentgemma's smoke config: one output of the first
    decode-attention call one bf16 ulp up moves the plain step's logits,
    by a rounding's size, on a copy of the prefilled cache, and the decode
    wrappers are back in place after it.  In fp32, as the smoke model's
    bf16 logits would round such a change away."""
    import importlib.util
    import os
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = get_smoke_config('recurrentgemma-9b')
    model, params = serve.build(cfg, 'cpu', seed=0)
    toks = torch.from_numpy(_tokens(cfg, s=16)).long()
    _, cache = serve.prefill_step(model, params, toks, max_len=24)
    twin = cs.clone_tree(cache)
    tok, pos0 = torch.zeros((B,), dtype=torch.int64), 16
    wrappers = ops.decode_attention, ops.decode_attention_int8
    with torch.inference_mode():
        lg_p, _ = model.decode_step(params, tok, pos0, cache)
    sens = cs.first_step_sensitivity(torch, model, params, tok, pos0, twin,
                                     None, lg_p)
    assert 0 < sens < 1e-2
    assert (ops.decode_attention, ops.decode_attention_int8) == wrappers


# ------------------------------------------------------- the int8 export


@pytest.mark.parametrize('name', ARCHS)
def test_export_lm_matches_reference(name):
    """``quantize_params_for_serving`` bit for bit: ``w_r``, ``w_i``, the
    gate and input projections, ``in_proj`` and ``out_proj`` int8 with
    their scales; the conv taps, ``lam``, ``A_log``, ``D``, ``dt_bias``
    and the norm scales kept as they are; then ``fn`` against the
    reference's."""
    jm, jp, tm, tp = _build(name)
    jcfg, cfg = _cfgs(name)
    js, ts = j_export_lm(jp, jcfg), export_lm(tp, cfg)
    _same_tree(ts.params, js.params)
    lp = ts.params['blocks'][0]
    if name == 'mamba2-2.7b':
        m = lp['mamba']
        assert set(m['in_proj']) == set(m['out_proj']) == {'w_q', 'scale'}
        assert set(m['conv']) == {'w', 'b'}
        assert all(m[k].dtype == torch.float32
                   for k in ('A_log', 'D', 'dt_bias'))
    else:
        r = lp['rglru']
        assert all(set(r[k]) == {'w_q', 'scale'}
                   for k in ('wgate', 'wx', 'w_r', 'w_i', 'wo'))
        assert set(r['conv']) == {'w', 'b'} and 'lam' in r
    toks = _tokens(cfg, s=40)
    want = js.fn(js.params, toks)
    got = ts.fn(ts.params, torch.from_numpy(toks).long())
    _close(got.numpy(), want)


# ------------------------------------------------------- family hooks

VOCAB, SEQ = 64, 16


def test_shrink_keeps_whole_groups_and_exits_sit_after_them():
    jf = jfamily.LMFamily(JTokens(VOCAB), seq=SEQ)
    tf = tfamily.LMFamily(SyntheticTokens(VOCAB), seq=SEQ, device='cpu')
    for name in ARCHS:
        tc, jc = get_config(name), j_get_config(name)
        for factor in (0.5, 0.25, 1.0):
            got = tf.shrink(tc, factor)
            assert dataclasses.asdict(got) == \
                dataclasses.asdict(jf.shrink(jc, factor))
            assert got.num_layers % len(tc.block_pattern) == 0
        assert tf.default_exit_points(tc) == jf.default_exit_points(jc)
    assert tf.shrink(get_config('recurrentgemma-9b'), 0.5).num_layers == 18


@pytest.mark.parametrize('name', ARCHS)
def test_prune_and_factorize_match_reference(name):
    """``prune(0.3)``: mamba2 comes back unchanged (no MLP: P does not
    apply), recurrentgemma keeps the reference's MLP channels; then
    ``factorize`` factors only the MLPs, so mamba2's ``mac_scale`` is 1."""
    jf = jfamily.LMFamily(JTokens(VOCAB), seq=SEQ)
    tf = tfamily.LMFamily(SyntheticTokens(VOCAB), seq=SEQ, device='cpu')
    jcfg, cfg = _cfgs(name)
    p = _params(name)
    tparams = from_jax_params(p)
    tp, tc2 = tf.prune(tparams, cfg, 0.3)
    jp, jc2 = jf.prune(jax.tree.map(jnp.asarray, p), jcfg, 0.3)
    assert dataclasses.asdict(tc2) == dataclasses.asdict(jc2)
    _same_tree(tp, jp)
    if name == 'mamba2-2.7b':
        assert tp is tparams and tc2 == cfg
    else:
        assert tc2.d_ff == 179
    fp, fc, fs = tf.factorize(tp, tc2, energy=0.6)
    jfp, _, jfs = jf.factorize(jp, jc2, energy=0.6)
    assert fs == jfs and fc == tc2
    _same_tree(fp, jfp)
    assert (fs == 1.0) == (name == 'mamba2-2.7b')


def _chain_batch(seed, n, torch_side):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, VOCAB, size=(n, SEQ + 1))
    if torch_side:
        return {'tokens': torch.from_numpy(t[:, :-1]),
                'labels': torch.from_numpy(t[:, 1:])}
    return {'tokens': jnp.asarray(t[:, :-1], jnp.int32),
            'labels': jnp.asarray(t[:, 1:], jnp.int32)}


_CHAIN_LAYERS = {'recurrentgemma-9b': 6, 'mamba2-2.7b': 4}


@functools.lru_cache(maxsize=None)
def _chain_init(name, layers):
    jcfg, _ = _cfgs(name, vocab_size=VOCAB, num_layers=layers)
    return jax.tree.map(np.asarray, jax.jit(j_build_model(jcfg).init)(
        jax.random.key(0)))


def _head(g, d):
    """Exit head ``g``'s weights, shared by both packages."""
    w = _rand((d, d), 200 + g, 1 / np.sqrt(d))
    return {'norm': {'scale': np.ones((d,), np.float32)},
            'adapter': {'w': w}}


def _families(name):
    """Both packages' LM families on fixed batches, initial weights and
    exit heads, so that their random streams never enter."""
    class JFixed(jfamily.LMFamily):
        def train_batch(self, key, n):
            return _chain_batch(1, n, False)

        def eval_batches(self, n, batch, seed=10_000):
            return [_chain_batch(2, 8, False), _chain_batch(3, 8, False)]

        def init(self, key, cfg):
            return jax.tree.map(jnp.asarray,
                                _chain_init(name, cfg.num_layers))

        def add_exits(self, key, params, cfg, groups):
            params, cfg = super().add_exits(key, params, cfg, groups)
            params['exit_heads'] = {
                g: jax.tree.map(jnp.asarray, _head(int(g), cfg.d_model))
                for g in params['exit_heads']}
            return params, cfg

    class TFixed(tfamily.LMFamily):
        def train_batch(self, gen, n):
            return _chain_batch(1, n, True)

        def eval_batches(self, n, batch, seed=10_000):
            return [_chain_batch(2, 8, True), _chain_batch(3, 8, True)]

        def init(self, gen, cfg):
            return from_jax_params(_chain_init(name, cfg.num_layers))

        def add_exits(self, gen, params, cfg, groups):
            params, cfg = super().add_exits(gen, params, cfg, groups)
            params['exit_heads'] = {
                g: from_jax_params(_head(int(g), cfg.d_model))
                for g in params['exit_heads']}
            return params, cfg
    return (JFixed(JTokens(VOCAB), seq=SEQ),
            TFixed(SyntheticTokens(VOCAB), seq=SEQ, device='cpu'))


@pytest.mark.parametrize('name', ARCHS)
def test_dplqe_chain_matches_reference(name):
    """A one-step DPLQE chain through both packages' ``run_chain`` (D
    halves the depth in whole groups, P skips mamba2, L factors only
    MLPs, Q at W8A0, E's heads after the scan groups): the same configs,
    ranks and kept shapes, the records' BitOpsCR and CR equal, accuracies
    within two eval tokens, the same exit fractions."""
    layers = _CHAIN_LAYERS[name]
    jcfg, cfg = _cfgs(name, vocab_size=VOCAB, num_layers=layers)
    hps = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
           'L': {'energy': 0.6, 'min_rank': 8},
           'Q': {'w_bits': 8, 'a_bits': 0}, 'E': {'threshold': 0.03}}
    kw = dict(batch=4, steps=1, lr=1e-3, eval_n=2, eval_batch=8)
    jf, tf = _families(name)
    t = tchain.run_chain(tf, cfg, 'DPLQE', hps, tpasses.Trainer(**kw),
                         pretrain_steps=1)
    j = jchain.run_chain(jf, jcfg, 'DPLQE', hps, jpasses.Trainer(**kw),
                         pretrain_steps=1)
    assert [h['pass'] for h in t.history] == \
        ['baseline', 'D', 'P', 'L', 'Q', 'E'] == \
        [h['pass'] for h in j.history]
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert t.cfg.num_layers == layers // 2 and t.cfg.w_bits == 8
    assert [a.shape for a in tree_leaves(t.params)] == \
        [np.shape(b) for b in jax.tree.leaves(j.params)]
    for a, b in zip(t.history, j.history):
        assert (a['BitOpsCR'], a['CR']) == (b['BitOpsCR'], b['CR']), a
        assert abs(a['acc'] - b['acc']) <= 2 / (2 * 8 * SEQ), a
    assert t.exit_probs == j.exit_probs
    assert t.lowrank_scale == j.lowrank_scale
    assert (t.lowrank_scale == 1.0) == (name == 'mamba2-2.7b')
    lg = tfm.forward(t.params, t.cfg, _chain_batch(4, 2, True)['tokens'])
    assert bool(torch.isfinite(lg).all())


# ------------------------------------------------ gradient compression


def test_int8_compress_grads_matches_reference_bit_for_bit():
    """Three rounds of error feedback over a tree with a zero leaf, a tiny
    one and a list: codes, scales, residuals and the decompressed
    gradients bit for bit against the reference's (eager, as it is
    called), and the export from ``optim``."""
    rng = np.random.default_rng(0)
    g = {'a': rng.standard_normal((64, 96)).astype(np.float32),
         'b': [rng.standard_normal(7).astype(np.float32) * 1e-3,
               np.zeros(3, np.float32)],
         'c': (rng.standard_normal((5, 4)) * 40).astype(np.float32)}
    jr = tr = None
    for rnd in range(3):
        gi = jax.tree.map(lambda x: x * (rnd + 1) + rnd, g)
        jq, js, jr = j_compress(jax.tree.map(jnp.asarray, gi), jr)
        tq, ts, tr = int8_compress_grads(from_jax_params(gi), tr)
        _same_tree((tq, ts, tr), (jq, js, jr))
        _same_tree(int8_decompress(tq, ts), j_decompress(jq, js))
        assert tq['a'].dtype == torch.int8 and ts['a'].dim() == 0


# ------------------------------- the decode kernel at recurrentgemma's group


def test_decode_plan_at_recurrentgemma_shape():
    """recurrentgemma-9b's decode call (B, H, K, D, S) = (8, 16, 1, 256,
    584): 16 query heads over one kv head at head_dim 256 run as two
    chunks of 8 in one launch, each within SMEM_BUDGET for every cache
    type; the chunks' block columns take every head of every kv head once
    (the kernel's index math).  Every shape that ran before keeps one
    chunk."""
    G, chunks = da.group_split(16, 256)
    assert (G, chunks) == (8, 2)
    for elem in (1, 2, 4):
        c, spb, w = da.split_plan(8, 1, 584, elem=elem, D=256, G=G,
                                  chunks=chunks)
        assert (c, spb) == (8, 73) and 8 * chunks * c == 128
        assert da.split_smem_bytes(w, G, 256, elem) <= SMEM_BUDGET
        assert w == -(-spb // 16) or da.split_smem_bytes(
            w + 1, G, 256, elem) > SMEM_BUDGET
    for D in da.HEAD_DIMS:
        for g in range(1, da.MAX_GROUP + 1):
            G, chunks = da.group_split(g, D)
            assert G * D <= da.MAX_GROUP_X_D
            if da.group_pad(g) * D <= da.MAX_GROUP_X_D:
                assert (G, chunks) == (da.group_pad(g), 1)
            for K in (1, 3):
                heads = []
                for x in range(K * chunks):      # blockIdx.x
                    kh, ci = divmod(x, chunks)
                    n = min(min(g, G), g - ci * min(g, G))
                    assert 1 <= n <= G
                    heads += [kh * g + ci * min(g, G) + i for i in range(n)]
                assert heads == list(range(K * g))


@pytest.mark.parametrize('kv_bits', [0, 8])
def test_plain_decode_at_group_16_head_dim_256_matches_reference(kv_bits):
    """Both plain versions at (2, 16, 1, 256, 40) with a hole in the mask
    against ``jax.jit`` of the reference model's decode math, fp32 within
    1e-5 x max."""
    Bq, H, K, D, Sc = 2, 16, 1, 256, 40
    q, k, v = _rand((Bq, H, D), 1), _rand((Bq, Sc, K, D), 2), \
        _rand((Bq, Sc, K, D), 3)
    valid = np.ones(Sc, bool)
    valid[10:14] = False
    cur = Sc - 1
    cache = {'meta': {'slots': jnp.arange(Sc, dtype=jnp.int32),
                      'pos': jnp.asarray(np.where(valid, np.arange(Sc), -1),
                                         jnp.int32),
                      'total': jnp.asarray(Sc, jnp.int32)}}
    if kv_bits:
        kq, ks = jattn.kv_quantize(jnp.asarray(k))
        vq, vs = jattn.kv_quantize(jnp.asarray(v))
        cache.update(k=kq, v=vq, k_s=ks, v_s=vs)
        nk = jattn.kv_dequantize(kq, ks, jnp.float32)[:, cur]
        nv = jattn.kv_dequantize(vq, vs, jnp.float32)[:, cur]
    else:
        cache.update(k=jnp.asarray(k), v=jnp.asarray(v))
        nk, nv = jnp.asarray(k[:, cur]), jnp.asarray(v[:, cur])
    want = jax.jit(lambda q, nk, nv, c: jattn.decode_attn_reference(
        q, nk, nv, c, jnp.asarray(cur, jnp.int32))[0])(q, nk, nv, cache)
    tv = torch.from_numpy(valid)
    if kv_bits:
        got = da.decode_attention_int8(
            torch.from_numpy(q), *(torch.from_numpy(np.array(a))
                                   for a in (kq, vq, ks, vs)), tv)
    else:
        got = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  tv)
    _close(got, want)


# ------------------------------------------------------------- serving


def _reference_greedy(jm, jp, toks, tokens):
    """The reference's launch/serve.py loop without the mesh: the jitted
    prefill, then ``tokens`` jitted greedy steps from token 0."""
    pos0 = toks.shape[1]
    _, cache = jax.jit(functools.partial(jm.prefill,
                                         max_len=pos0 + tokens + 8))(
        jp, {'tokens': toks})

    @jax.jit
    def step(p, tok, cur, cache):
        logits, cache = jm.decode_step(p, tok, cur, cache)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    tok = jnp.zeros((toks.shape[0],), jnp.int32)
    out = []
    for t in range(tokens):
        tok, cache = step(jp, tok, jnp.asarray(pos0 + t, jnp.int32), cache)
        out.append(np.asarray(tok))
    return np.stack(out)


@pytest.mark.parametrize('name', ARCHS)
def test_serve_loop_greedy_tokens_match_reference(name, capsys):
    """4 greedy tokens of launch/serve.py's functions equal the
    reference's loop on the same params and prompt: recurrentgemma's
    local layer on the plain decode attention once a step, mamba2 on no
    decode kernel; then ``serve --smoke --device cpu`` runs the arch
    whole, bf16 and int8 with the int8 cache."""
    jm, jp, tm, tp = _build(name)
    steps = 4
    toks = _tokens(tm.cfg)
    want = _reference_greedy(jm, jp, toks, steps)
    reset_counts()
    _, cache = serve.prefill_step(tm, tp, torch.from_numpy(toks).long(),
                                  max_len=S + steps + 8)
    got = serve.decode(tm, tp, cache, torch.zeros(B, dtype=torch.int64),
                       pos0=S, tokens=steps)
    np.testing.assert_array_equal(got.numpy(), want)
    local = sum(k == 'local' for k in tm.cfg.layer_kinds())
    assert counts()['decode_attention'] == {'launches': 0,
                                            'plain_calls': local * steps}
    assert counts()['decode_attention_int8']['plain_calls'] == 0
    for extra in ([], ['--int8-weights', '--kv-cache-bits', '8']):
        argv = ['--arch', name, '--smoke', '--device', 'cpu', '--batch',
                '2', '--prompt-len', '8', '--tokens', '4'] + extra
        assert serve.main(argv) == 0
        assert f'{name}-smoke' in capsys.readouterr().out
