"""Parity of the port's MoE and MLA blocks against the JAX package:
mixtral-8x7b (top-2 of 8 experts, sliding-window GQA) and
deepseek-v3-671b (MLA, a shared expert, leading dense layers, top-8 of
256), on each arch's smoke config (``reduced``: d_model 128, fp32; 4
experts top-2, deepseek's MLA ranks 64/32, head dims 16 + 32, v 32) and
on narrow configs with every structural field of the published ones.

One reference build per arch (module-scope fixtures); its params cross
through ``repro_torch.interop`` and the same numpy inputs go through both.
Every reference function runs under ``jax.jit``, and the port's QAT
scales under ``quantization.jitted_scales``.  Tolerances:

* routing (the top-k experts of each token) and the dispatch (the kept
  assignments and their buffer rows) equal.  ``jax.lax.top_k`` breaks a
  tie to the lower index and ``torch.topk`` promises no order, and the
  two packages' fp32 router products differ by rounding, so a token whose
  k-th and (k+1)-th probabilities lie within ``NEAR_TIE`` may route
  apart: such tokens are counted and reported, never hidden by a looser
  tolerance, and only they may differ (none does on these inputs);
* outputs and logits within 1e-5 x max|.| (XLA and torch sum in other
  orders); an int8-KV step whose cache holds a code one step apart at a
  rounding tie within 1e-3 (tests/test_torch_archs.py);
* int8 codes and scales, pruned trees, ranks and BitOps: bit for bit.

About 70 s on one CPU core.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
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
from repro.core.quantization import \
    quantize_params_for_serving as j_quantize_for_serving
from repro.data import SyntheticTokens as JTokens
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.layers import dense as j_dense
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core import bitops
from repro_torch.core import chain as tchain
from repro_torch.core import family as tfamily
from repro_torch.core import passes as tpasses
from repro_torch.core.export import export_lm
from repro_torch.core.quantization import (jitted_scales, quantize_weight,
                                           quantize_params_for_serving)
from repro_torch.data import SyntheticTokens
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.kernels import counts, reset_counts
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model, param_count
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = ('mixtral-8x7b', 'deepseek-v3-671b')
B, S, STEPS = 2, 12, 3
TOL = 1e-5
CODE_FLIP_TOL = 1e-3
NEAR_TIE = 1e-6


def _cfgs(name, **kw):
    """(reference config, port config): the arch's smoke config."""
    return (j_get_smoke_config(name).replace(**kw),
            get_smoke_config(name).replace(**kw))


def _narrow(name):
    """A narrow config with every structural field of the published one:
    mixtral's 8 experts top-2 over 3 local layers; deepseek's 256 experts
    top-8 with its shared expert, 3 leading dense layers and 2 MoE layers,
    MLA at small ranks."""
    kw = dict(d_model=64, num_heads=4, vocab_size=64, d_ff=96, moe_d_ff=16,
              window=32)
    if name == 'mixtral-8x7b':
        kw.update(num_layers=3, num_kv_heads=2, head_dim=16)
    else:
        kw.update(num_layers=5, num_kv_heads=4, head_dim=24, q_lora_rank=32,
                  kv_lora_rank=16, rope_head_dim=8, nope_head_dim=16,
                  v_head_dim=16)
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
    assert _rel(got, want) <= tol


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


# ------------------------------------------------------------ configs


@pytest.mark.parametrize('name', ARCHS)
def test_configs_match_reference(name):
    assert name in ARCH_NAMES
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(get_smoke_config(name)) == \
        dataclasses.asdict(j_get_smoke_config(name))
    cfg = get_config(name)
    assert cfg.capacity_factor == 1.25
    if name == 'deepseek-v3-671b':
        assert (cfg.first_dense_layers, cfg.q_lora_rank, cfg.kv_lora_rank,
                cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim) == \
            (3, 1536, 512, 64, 128, 128)


@pytest.mark.parametrize('name', ARCHS)
@pytest.mark.parametrize('bits', [(0, 0), (8, 8), (4, 8)])
def test_bitops_of_the_published_configs_match_reference(name, bits):
    """BitOps count the active experts and MLA's projections: the port's
    copy of ``core/bitops.py`` gives the reference's numbers, with and
    without exits, and the storage bits of a tree."""
    tc = get_config(name).replace(w_bits=bits[0], a_bits=bits[1])
    jc = j_get_config(name).replace(w_bits=bits[0], a_bits=bits[1])
    for seq in (128, 4096):
        assert bitops.lm_bitops(tc, seq) == j_bitops.lm_bitops(jc, seq)
    ep = {5: 0.25, 20: 0.5}
    assert bitops.lm_bitops(tc, 128, exit_probs=ep) == \
        j_bitops.lm_bitops(jc, 128, exit_probs=ep)
    p = _params(name)
    assert bitops.param_storage_bits(from_jax_params(p), 8) == \
        j_bitops.param_storage_bits(p, 8)


def test_build_model_builds_moe_and_mla():
    for name in ARCHS:
        assert build_model(get_config(name)).cfg.name == name


# ----------------------------------------------------------- param trees


@pytest.mark.parametrize('shape', ['smoke', 'narrow'])
@pytest.mark.parametrize('name', ARCHS)
def test_param_tree_matches_reference(name, shape):
    """The port's init gives the reference's tree, shapes and dtypes
    (``jax.eval_shape`` of its init): the prefix's dense MLPs, the stacked
    ``(G, E, d, f)`` experts and ``(G, d, E)`` router, the shared expert,
    MLA's per-head ``(G, r, H, d)`` up-projections; a bf16 tree crosses
    bit for bit both ways."""
    jcfg, cfg = _cfgs(name) if shape == 'smoke' else _narrow(name)
    jp = jax.eval_shape(j_build_model(jcfg).init, jax.random.key(0))
    tp = build_model(cfg).init(torch.Generator().manual_seed(0), 'cpu')
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(to_numpy(tp))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == b.shape and a.dtype == b.dtype
    assert param_count(tp) == sum(a.size for _, a in jl)
    n_prefix, G, _, R = tfm.layer_groups(cfg)
    assert all('mlp' in lp for lp in tp['prefix'])
    assert all('moe' in lp for lp in tp['blocks'] + tp['tail'])
    E = cfg.n_experts
    assert tp['blocks'][0]['moe']['wi'].shape == (G, E, cfg.d_model,
                                                  cfg.moe_d_ff)
    assert ('shared' in tp['blocks'][0]['moe']) == (name != 'mixtral-8x7b')
    if cfg.use_mla:
        assert tp['blocks'][0]['attn']['wk_b'].shape == \
            (G, cfg.kv_lora_rank, cfg.num_heads, cfg.nope_head_dim)
    jb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      _params(name))
    back = to_numpy(from_jax_params(jb))
    for a, b in zip(jax.tree.leaves(jb), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))


# -------------------------------------------------------------- the MoE block

# (arch, config changes, (B, S)): the prompt (T = 24), and decode at T = 8
# where the capacity drops tokens: mixtral's published 8 experts top-2 make
# T * k / E * 1.25 exactly 2.5, which rounds to 2 (half to even);
# deepseek's top-8 of 64 experts makes it 1.25, a capacity of 1, as the
# published 256 experts do at batch 8
MOE_CASES = {
    'mixtral-prompt': ('mixtral-8x7b', {}, (B, S)),
    'mixtral-decode-cap2': ('mixtral-8x7b', {'n_experts': 8}, (8, 1)),
    'deepseek-prompt': ('deepseek-v3-671b', {}, (B, S)),
    'deepseek-decode-cap1': ('deepseek-v3-671b',
                             {'n_experts': 64, 'top_k': 8}, (8, 1)),
}


@functools.lru_cache(maxsize=None)
def _moe_case(case):
    """(reference cfg, port cfg, block params as numpy, x) of a case."""
    name, kw, (b, s) = MOE_CASES[case]
    jcfg, cfg = _cfgs(name, **kw)
    p = jax.jit(functools.partial(jmoe.init_moe, cfg=jcfg))(
        jax.random.key(3))
    x = np.random.default_rng(5).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jax.tree.map(np.asarray, p), x


def _j_routing(p, x, cfg):
    """The reference's routing and dispatch, as ``_moe_block_dense``
    computes them (it returns neither)."""
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    probs = jax.nn.softmax(j_dense(p['router'], xf.astype(jnp.float32)), -1)
    _, eidx = jax.lax.top_k(probs, cfg.top_k)
    cap = int(max(1, round(T * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    eid = eidx.reshape(-1)
    order = jnp.argsort(eid)
    sorted_eid = eid[order]
    cnt = jnp.bincount(eid, length=cfg.n_experts)
    pos = jnp.arange(eid.size, dtype=jnp.int32) - (jnp.cumsum(cnt) -
                                                   cnt)[sorted_eid]
    keep = pos < cap
    dst = jnp.where(keep, sorted_eid * cap + pos, cfg.n_experts * cap)
    return probs, eidx, keep, dst


def _routing_flips(jprobs, jeidx, teidx, k):
    """Tokens whose top-k experts differ between the packages; each must
    lie at a near-tie (the k-th and (k+1)-th probabilities within
    NEAR_TIE).  Returns the differing rows."""
    je, te = np.sort(np.asarray(jeidx), -1), np.sort(teidx.numpy(), -1)
    rows = np.flatnonzero((je != te).any(-1))
    if rows.size:
        top = -np.sort(-np.asarray(jprobs)[rows], -1)
        margin = top[:, k - 1] - top[:, k]
        assert (margin < NEAR_TIE).all(), margin
        warnings.warn(f'{rows.size} tokens route apart at near-ties '
                      f'(margins {margin})')
    return rows


def _serving_form(p):
    """Both packages' int8 serving form of a block's params."""
    jq = jax.tree.map(np.asarray, j_quantize_for_serving(
        jax.tree.map(jnp.asarray, p)))
    return jq, from_jax_params(jq)


@pytest.mark.parametrize('quant', ['bf', 'w8a8', 'int8'])
@pytest.mark.parametrize('case', list(MOE_CASES))
def test_moe_block_matches_reference(case, quant):
    """The routing and the dispatch first (the same experts, the same kept
    assignments in the same buffer rows; at decode the capacity drops
    some), then the block's output within 1e-5 x max, at full precision,
    W8A8 fake quant, and on the int8 serving form."""
    jcfg, cfg, p, x = _moe_case(case)
    bits = (8, 8) if quant == 'w8a8' else (0, 0)
    jp, tp = (jax.tree.map(jnp.asarray, p), from_jax_params(p))
    if quant == 'int8':
        jp, tp = _serving_form(p)
        jp = jax.tree.map(jnp.asarray, jp)
        assert set(tp['wi']) == {'w_q', 'scale'} and \
            set(tp['router']) == {'w_q', 'scale'}
    jprobs, jeidx, jkeep, jdst = jax.jit(
        functools.partial(_j_routing, cfg=jcfg))(jp, x)
    tx = torch.from_numpy(x)
    with jitted_scales(), torch.no_grad():
        _, gates, teidx = moe.route(tp, tx.reshape(-1, cfg.d_model), cfg)
        cap = moe.capacity(x.shape[0] * x.shape[1], cfg)
        _, keep, dst, _ = moe.dispatch(teidx, cfg.n_experts, cap)
        got = moe.moe_block(tp, tx, cfg, quant=bits)
    flips = _routing_flips(jprobs, jeidx, teidx, cfg.top_k)
    want = jax.jit(functools.partial(jmoe.moe_block, cfg=jcfg,
                                     quant=bits))(jp, x)
    if flips.size:           # compare the tokens that route alike
        ok = np.setdiff1d(np.arange(teidx.shape[0]), flips)
        _close(got.reshape(-1, cfg.d_model).numpy()[ok],
               np.asarray(want).reshape(-1, cfg.d_model)[ok])
        return
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(jeidx))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    if case.endswith('cap2'):
        assert cap == 2 and not keep.all()
    if case.endswith('cap1'):
        assert cap == 1 and not keep.all()
    _close(got.numpy(), want)
    assert torch.allclose(gates.sum(-1), torch.ones(gates.shape[0]))


@pytest.mark.parametrize('case', ['mixtral-prompt', 'deepseek-prompt'])
def test_moe_aux_loss_matches_reference(case):
    jcfg, cfg, p, x = _moe_case(case)
    want = jax.jit(functools.partial(jmoe.moe_aux_loss, cfg=jcfg))(
        jax.tree.map(jnp.asarray, p), x)
    got = moe.moe_aux_loss(from_jax_params(p), torch.from_numpy(x), cfg)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_moe_block_gradients_match_reference():
    """The Q pass trains through the block: the gradients of a loss on its
    output, every expert's and the router's, within 1e-5 x the largest."""
    jcfg, cfg, p, x = _moe_case('deepseek-prompt')

    def jloss(q):
        return jnp.sum(jnp.square(jmoe.moe_block(q, jnp.asarray(x), jcfg)))
    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, p))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), p)
    torch.sum(torch.square(moe.moe_block(tp, torch.from_numpy(x),
                                         cfg))).backward()
    got, want = tree_leaves(tp), jax.tree.leaves(jg)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for a, b in zip(got, want):
        assert float(np.abs(a.grad.numpy() - np.asarray(b)).max()) <= \
            1e-5 * top


# ------------------------------------------------------------------- MLA


def test_mla_forward_decode_and_cache_writes_match_reference():
    """deepseek's smoke MLA block (q/k head dim 16 + 32, v 32): the
    prefill attention (``chunked_attention`` at Dq 48, Dv 32, k broadcast
    over the heads) and its cache entries, the prefill cache write, then
    three absorbed-latent decode steps: each output and the cache's
    latents, rope keys and positions against the reference's."""
    jcfg, cfg = _cfgs('deepseek-v3-671b')
    p = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jattn.init_mla, cfg=jcfg))(jax.random.key(7)))
    jp, tp = jax.tree.map(jnp.asarray, p), from_jax_params(p)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jout, (jckv, jkr) = jax.jit(functools.partial(
        jattn.mla_forward, cfg=jcfg))(jp, x, pos)
    with torch.no_grad():
        tout, (tckv, tkr) = tattn.mla_forward(
            tp, torch.from_numpy(x), torch.from_numpy(pos), cfg)
    _close(tout.numpy(), jout)
    _close(tckv.numpy(), jckv)
    _close(tkr.numpy(), jkr)
    max_len = S + STEPS + 2
    jc = jattn.prefill_mla_cache_write(
        jattn.init_mla_cache(jcfg, B, max_len, jnp.float32), jckv, jkr,
        jnp.asarray(pos))
    tc = tattn.prefill_mla_cache_write(
        tattn.init_mla_cache(cfg, B, max_len, torch.float32), tckv, tkr,
        torch.from_numpy(pos))
    np.testing.assert_array_equal(tc['meta']['pos'].numpy(),
                                  np.asarray(jc['meta']['pos']))
    jstep = jax.jit(functools.partial(jattn.mla_decode, cfg=jcfg, ctx={}))
    for t in range(STEPS):
        xt = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
        jo, jc = jstep(jp, xt, jnp.asarray(S + t, jnp.int32), cache=jc)
        with torch.no_grad():
            to, tc = tattn.mla_decode(tp, torch.from_numpy(xt), S + t, cfg,
                                      cache=tc, ctx={})
        _close(to.numpy(), jo)
        _close(tc['ckv'].numpy(), jc['ckv'])
        _close(tc['kr'].numpy(), jc['kr'])
        np.testing.assert_array_equal(tc['meta']['pos'].numpy(),
                                      np.asarray(jc['meta']['pos']))
    assert tc['meta']['pos'].tolist() == list(range(S + STEPS)) + [-1] * 2


def test_mla_decode_takes_an_injected_function():
    """``ctx['decode_mla']`` replaces the latent attention, as
    ``ctx['decode_attn']`` does for GQA."""
    _, cfg = _cfgs('deepseek-v3-671b')
    tp = tattn.init_mla(torch.Generator().manual_seed(0), cfg)
    cache = tattn.init_mla_cache(cfg, 2, 8, torch.float32)
    seen = []

    def fn(q_lat, q_rope, ckv, kr, c, cur):
        seen.append((tuple(q_lat.shape), tuple(q_rope.shape), cur))
        return tattn.decode_mla_reference(q_lat, q_rope, ckv, kr, c, cur)
    with torch.no_grad():
        tattn.mla_decode(tp, torch.ones(2, cfg.d_model), 3, cfg,
                         cache=cache, ctx={'decode_mla': fn})
    assert seen == [((2, 4, 32), (2, 4, 16), 3)]


# ---------------------------------------------------------- the whole model


@pytest.mark.parametrize('name', ARCHS)
def test_forward_matches_reference(name):
    jm, jp, tm, tp = _build(name)
    toks = _tokens(tm.cfg)
    want = jax.jit(jm.forward)(jp, {'tokens': toks})
    with torch.inference_mode():
        got = tm.forward(tp, {'tokens': torch.from_numpy(toks).long()})
    _close(got.numpy(), want)


@pytest.mark.parametrize('kv_bits', [0, 8])
@pytest.mark.parametrize('name', ARCHS)
def test_prefill_and_decode_match_reference(name, kv_bits):
    """Prefill logits and cache, then STEPS decode steps, each step's
    logits and cache positions against the reference's.  deepseek's MLA
    cache ignores kv_cache_bits in both packages: no int8 leaf."""
    jm, jp, tm, tp = _build(name, kv_cache_bits=kv_bits)
    toks = _tokens(tm.cfg)
    max_len = S + STEPS + 4
    jl, jc = jax.jit(functools.partial(jm.prefill, max_len=max_len))(
        jp, {'tokens': toks})
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {'tokens': torch.from_numpy(toks).long()},
                            max_len=max_len)
    _close(tl.numpy(), jl)
    jcn, tcn = jax.tree.map(np.asarray, jc), to_numpy(tc)
    assert jax.tree.structure(jcn) == jax.tree.structure(tcn)
    int8 = [a for a in jax.tree.leaves(tcn) if a.dtype == np.int8]
    assert bool(int8) == (kv_bits == 8 and not tm.cfg.use_mla)
    jstep = jax.jit(jm.decode_step)
    tok = np.array([7, 11], np.int32)
    for t in range(STEPS):
        jl, jc = jstep(jp, tok, jnp.asarray(S + t, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), S + t,
                                    tc)
        flips = _code_flips(jc, tc) if int8 else 0
        _close(tl.numpy(), jl, CODE_FLIP_TOL if flips else TOL)
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                        tree_leaves(to_numpy(tc))):
            if a.dtype == np.int32:
                np.testing.assert_array_equal(b, a)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


# ------------------------------------------------------- the int8 export


@pytest.mark.parametrize('name', ARCHS)
def test_export_lm_matches_reference(name):
    """``quantize_params_for_serving``: every leaf bit for bit (the
    experts' ``{'w_q', 'scale'}`` with the scale kept over every axis but
    -2, quantized slice by slice in the port; the router and the shared
    expert as dense weights; MLA's ``wk_b``/``wv_b`` float), then ``fn``
    against the reference's."""
    jm, jp, tm, tp = _build(name)
    jcfg, cfg = _cfgs(name)
    js, ts = j_export_lm(jp, jcfg), export_lm(tp, cfg)
    _same_tree(ts.params, js.params)
    mp = ts.params['blocks'][0]['moe']
    G, E = cfg.num_layers - cfg.first_dense_layers, cfg.n_experts
    assert mp['wi']['scale'].shape == (G, E, 1, cfg.moe_d_ff)
    assert set(mp['router']) == {'w_q', 'scale'}
    if cfg.use_mla:
        att = ts.params['blocks'][0]['attn']
        assert att['wk_b'].dtype == torch.float32 and 'w' not in att['wo']
    # slice by slice equals the whole leaf at once
    w = tp['blocks'][0]['moe']['wo']
    q, s = quantize_weight(w, 8, axis=(0, 1, 3))
    assert torch.equal(q.to(torch.int8), mp['wo']['w_q'])
    assert torch.equal(s, mp['wo']['scale'])
    toks = _tokens(cfg)
    want = js.fn(js.params, toks)
    got = ts.fn(ts.params, torch.from_numpy(toks).long())
    _close(got.numpy(), want)


def test_quantize_params_for_serving_keeps_bf16_experts_exact():
    """A bf16 tree (as served on the card) through both packages'
    ``quantize_params_for_serving``: the same codes and scales."""
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                     _params('mixtral-8x7b'))
    want = j_quantize_for_serving(jax.tree.map(jnp.asarray, p))
    got = quantize_params_for_serving(from_jax_params(p))
    _same_tree(got, want)


# ------------------------------------------------------- family hooks

VOCAB, SEQ = 64, 16


def _unstacked(name):
    """The smoke config with a pattern of two layers and three layers
    after the dense prefix: one stacked group of two and an unstacked MoE
    tail layer."""
    prefix = get_smoke_config(name).first_dense_layers
    return _cfgs(name, num_layers=prefix + 3,
                 block_pattern=('global', 'global'), n_experts=8,
                 vocab_size=VOCAB)


@pytest.mark.parametrize('layout', ['stacked', 'unstacked'])
@pytest.mark.parametrize('name', ARCHS)
def test_prune_experts_keeps_the_references_experts(name, layout):
    """``prune(ratio=0.3)`` of an MoE config keeps max(top_k, int(8 x
    0.7)) = 5 experts by router column norm: the same experts, a stacked
    group's in the reference's importance order, an unstacked layer's
    sorted; the shared expert and the dense MLPs stay whole."""
    jf = jfamily.LMFamily(JTokens(VOCAB), seq=SEQ)
    tf = tfamily.LMFamily(SyntheticTokens(VOCAB), seq=SEQ, device='cpu')
    jcfg, cfg = _unstacked(name) if layout == 'unstacked' else \
        _cfgs(name, n_experts=8, vocab_size=VOCAB)
    p = jax.tree.map(np.asarray, jax.jit(j_build_model(jcfg).init)(
        jax.random.key(4)))
    jp, jc2 = jf.prune(jax.tree.map(jnp.asarray, p), jcfg, 0.3)
    tp, tc2 = tf.prune(from_jax_params(p), cfg, 0.3)
    assert tc2.n_experts == jc2.n_experts == 5
    assert dataclasses.asdict(tc2) == dataclasses.asdict(jc2)
    _same_tree(tp, jp)
    full = p['blocks'][0]['moe']['router']['w']           # (G, d, E)
    got = tp['blocks'][0]['moe']['router']['w'].numpy()
    kept = [[int(np.flatnonzero((full[g].T == col).all(1))[0])
             for col in got[g].T] for g in range(full.shape[0])]
    assert any(k != sorted(k) for k in kept)              # importance order
    if layout == 'unstacked':
        r = tp['tail'][0]['moe']['router']['w'].numpy()
        full = p['tail'][0]['moe']['router']['w']
        kept = [int(np.flatnonzero((full.T == col).all(1))[0])
                for col in r.T]
        assert len(kept) == 5 and kept == sorted(kept)
    if name == 'deepseek-v3-671b':
        assert tp['blocks'][0]['moe']['shared']['wi']['w'].shape == \
            p['blocks'][0]['moe']['shared']['wi']['w'].shape
    lg = tfm.forward(tp, tc2, torch.from_numpy(_tokens(tc2)).long())
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize('name', ARCHS)
def test_factorize_leaves_experts_and_counts_them(name):
    """``factorize`` factors only the dense MLPs (deepseek's leading
    layer, unstacked, in numpy as the reference); the experts, the shared
    expert and MLA stay whole and count in ``mac_scale``, which equals the
    reference's."""
    jf = jfamily.LMFamily(JTokens(VOCAB), seq=SEQ)
    tf = tfamily.LMFamily(SyntheticTokens(VOCAB), seq=SEQ, device='cpu')
    jcfg, cfg = _cfgs(name)
    p = _params(name)
    jp, _, js = jf.factorize(jax.tree.map(jnp.asarray, p), jcfg, energy=0.6)
    tp, tc2, ts = tf.factorize(from_jax_params(p), cfg, energy=0.6)
    assert ts == js and tc2 == cfg
    _same_tree(tp, jp)
    if name == 'mixtral-8x7b':
        assert ts == 1.0
    else:
        assert 'u' in tp['prefix'][0]['mlp']['wi'] and ts < 1.0
        assert tfamily._linear_cost(tp['blocks'][0]['moe']) == \
            tfamily._linear_cost(from_jax_params(p['blocks'][0]['moe']))


def _chain_batch(seed, n, torch_side):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, VOCAB, size=(n, SEQ + 1))
    if torch_side:
        return {'tokens': torch.from_numpy(t[:, :-1]),
                'labels': torch.from_numpy(t[:, 1:])}
    return {'tokens': jnp.asarray(t[:, :-1], jnp.int32),
            'labels': jnp.asarray(t[:, 1:], jnp.int32)}


def _mixtral_chain_init():
    jcfg, _ = _cfgs('mixtral-8x7b', vocab_size=VOCAB)
    return jax.tree.map(np.asarray, jax.jit(j_build_model(jcfg).init)(
        jax.random.key(0)))


class _JFixed(jfamily.LMFamily):
    def train_batch(self, key, n):
        return _chain_batch(1, n, False)

    def eval_batches(self, n, batch, seed=10_000):
        return [_chain_batch(2, 8, False), _chain_batch(3, 8, False)]

    def init(self, key, cfg):
        return jax.tree.map(jnp.asarray, _mixtral_chain_init())


class _TFixed(tfamily.LMFamily):
    def train_batch(self, gen, n):
        return _chain_batch(1, n, True)

    def eval_batches(self, n, batch, seed=10_000):
        return [_chain_batch(2, 8, True), _chain_batch(3, 8, True)]

    def init(self, gen, cfg):
        return from_jax_params(_mixtral_chain_init())


def test_pq_chain_on_mixtral_matches_reference():
    """A one-step ``PQ`` chain on mixtral's smoke config (as the
    reference's ``tests/test_chain.py::test_lm_expert_pruning``, P at
    ratio 0.5: 2 experts of 4), Q at W8A0 through the MoE block: the same
    configs and kept shapes, the records' BitOpsCR and CR equal,
    accuracies within two eval tokens, finite logits."""
    jcfg, cfg = _cfgs('mixtral-8x7b', vocab_size=VOCAB)
    hps = {'P': {'ratio': 0.5}, 'Q': {'w_bits': 8, 'a_bits': 0}}
    kw = dict(batch=4, steps=1, lr=1e-3, eval_n=2, eval_batch=8)
    t = tchain.run_chain(_TFixed(SyntheticTokens(VOCAB), seq=SEQ,
                                 device='cpu'), cfg, 'PQ', hps,
                         tpasses.Trainer(**kw), pretrain_steps=1)
    j = jchain.run_chain(_JFixed(JTokens(VOCAB), seq=SEQ), jcfg, 'PQ', hps,
                         jpasses.Trainer(**kw), pretrain_steps=1)
    assert [h['pass'] for h in t.history] == ['baseline', 'P', 'Q'] == \
        [h['pass'] for h in j.history]
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    assert t.cfg.n_experts == 2 and t.cfg.w_bits == 8
    assert [a.shape for a in tree_leaves(t.params)] == \
        [np.shape(b) for b in jax.tree.leaves(j.params)]
    for a, b in zip(t.history, j.history):
        assert (a['BitOpsCR'], a['CR']) == (b['BitOpsCR'], b['CR']), a
        assert abs(a['acc'] - b['acc']) <= 2 / (2 * 8 * SEQ), a
    assert t.history[-1]['BitOpsCR'] > 1.0
    lg = tfm.forward(t.params, t.cfg,
                     _chain_batch(4, 2, True)['tokens'])
    assert bool(torch.isfinite(lg).all())


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


@pytest.mark.parametrize('kv_bits', [0, 8])
@pytest.mark.parametrize('name', ARCHS)
def test_serve_loop_greedy_tokens_match_reference(name, kv_bits, capsys):
    """4 greedy tokens of launch/serve.py's functions equal the
    reference's loop on the same params and prompt: mixtral's 2 local
    layers on the plain decode attention once a layer a step, deepseek's
    MLA on no decode kernel; then ``serve --smoke --device cpu`` runs the
    arch (deepseek saying that --kv-cache-bits leaves its cache as it
    is)."""
    jm, jp, tm, tp = _build(name, kv_cache_bits=kv_bits)
    steps = 4
    toks = _tokens(tm.cfg)
    want = _reference_greedy(jm, jp, toks, steps)
    reset_counts()
    _, cache = serve.prefill_step(tm, tp, torch.from_numpy(toks).long(),
                                  max_len=S + steps + 8)
    got = serve.decode(tm, tp, cache, torch.zeros(B, dtype=torch.int64),
                       pos0=S, tokens=steps)
    np.testing.assert_array_equal(got.numpy(), want)
    kern = 'decode_attention_int8' if kv_bits else 'decode_attention'
    calls = 0 if tm.cfg.use_mla else tm.cfg.num_layers * steps
    assert counts()[kern] == {'launches': 0, 'plain_calls': calls}
    argv = ['--arch', name, '--smoke', '--device', 'cpu', '--batch', '2',
            '--prompt-len', '8', '--tokens', '4', '--layers', '3']
    if kv_bits:
        argv += ['--int8-weights', '--kv-cache-bits', '8']
    assert serve.main(argv) == 0
    out = capsys.readouterr()
    assert f'{tm.cfg.name}-smoke' in out.out or name in out.out
    assert ('MLA latent cache' in out.err) == (bool(kv_bits) and
                                                tm.cfg.use_mla)
