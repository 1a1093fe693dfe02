"""Parity of the port's dense-attention archs against the JAX package, on
each arch's smoke config (``reduced``: 2 layers, or one whole block
pattern, d_model 128, 4 heads over 2 kv heads, head_dim 32, fp32) and a
reduced gemma2 with head_dim 256: gemma2-9b (local/global, window, both
softcaps, tied embedding), gemma3-12b (5:1 local/global), qwen2-72b (QKV
bias), internvl2-2b (a frontend prefix of patch embeddings) and
whisper-small (an encoder and cross-attention).

One reference build per arch (module-scope fixtures); its params cross
through ``repro_torch.interop`` and the same numpy inputs go through both.
Every reference function runs under ``jax.jit``, as the reference's
launchers run it.  Tolerance: logits within 1e-4 x max|logit| (XLA and
torch sum in other orders; their tanh differs by an ulp), as in
tests/test_torch_lm.py.  With an int8 KV cache the two packages quantize
k and v that differ by fp32 noise, so a code at a rounding tie can land
one step apart (ROADMAP C, "Activation codes at ties"); at head_dim 256
one such code in the 2-layer cache moves a step's logits by about 1e-4 x
max.  A step whose cache holds a code that differs is held to
CODE_FLIP_TOL instead, and every differing code must be one step apart
and rare.  About 60 s on one CPU core.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.export import export_lm as j_export_lm
from repro.models import build_model as j_build_model
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.export import export_lm
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.kernels import counts, reset_counts
from repro_torch.launch import serve
from repro_torch.models.model import build_model, param_count

torch.set_num_threads(1)

NEW_ARCHS = ('gemma2-9b', 'gemma3-12b', 'qwen2-72b', 'internvl2-2b',
             'whisper-small')
# the smoke configs, and gemma2 reduced at its published head_dim 256
CASES = NEW_ARCHS + ('gemma2-hd256',)
B, S, STEPS = 2, 12, 3
TOL = 1e-4
CODE_FLIP_TOL = 1e-3


def _cfgs(case, kv_bits=0):
    """(reference config, port config) of a case."""
    if case == 'gemma2-hd256':
        kw = dict(head_dim=256, kv_cache_bits=kv_bits)
        return (j_get_smoke_config('gemma2-9b').replace(**kw),
                get_smoke_config('gemma2-9b').replace(**kw))
    return (j_get_smoke_config(case).replace(kv_cache_bits=kv_bits),
            get_smoke_config(case).replace(kv_cache_bits=kv_bits))


def _inputs(cfg, n=B, s=S, seed=1):
    """The numpy batch of a case: tokens, and a VLM's patches or an
    encoder-decoder's frames (frontend_tokens rows of d_model)."""
    rng = np.random.default_rng(seed)
    batch = {'tokens': rng.integers(0, cfg.vocab_size,
                                    size=(n, s)).astype(np.int32)}
    extra = rng.standard_normal((n, cfg.frontend_tokens, cfg.d_model))
    if cfg.arch_kind == 'vlm':
        batch['patches'] = extra.astype(np.float32)
    if cfg.arch_kind == 'encdec':
        batch['frames'] = extra.astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == 'tokens'
            else torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _build(case, kv_bits=0):
    """(JAX model, JAX params, port model, port params): one reference
    build a case (the params do not depend on kv_bits)."""
    jcfg, cfg = _cfgs(case, kv_bits)
    jm = j_build_model(jcfg)
    jp = _params(case)
    return jm, jp, build_model(cfg), from_jax_params(jp)


@functools.lru_cache(maxsize=None)
def _params(case):
    jcfg, _ = _cfgs(case)
    return jax.jit(j_build_model(jcfg).init)(jax.random.key(0))


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _code_flips(jc, tc):
    """How many int8 cache codes differ between the two caches; each must
    be one step apart, and fewer than 1e-3 of the codes."""
    n = tot = 0
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jc)),
                    jax.tree.leaves(to_numpy(tc))):
        if a.dtype == np.int8:
            d = np.abs(a.astype(int) - b.astype(int))
            assert d.max() <= 1
            n, tot = n + int((d > 0).sum()), tot + d.size
    assert n <= 1e-3 * max(tot, 1), (n, tot)
    return n


def _enc(jm, jp, tm, tp, batch):
    """Both encoder outputs of an encoder-decoder's frames, else Nones."""
    if 'frames' not in batch:
        return None, None
    je = jax.jit(jm.encode)(jp, batch['frames'])
    with torch.inference_mode():
        te = tm.encode(tp, torch.from_numpy(batch['frames']))
    return je, te


@pytest.mark.parametrize('name', NEW_ARCHS)
def test_configs_match_reference(name):
    assert name in ARCH_NAMES
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(get_smoke_config(name)) == \
        dataclasses.asdict(j_get_smoke_config(name))


def test_registry_keeps_the_reference_order():
    from repro.configs import ARCH_NAMES as J_NAMES
    assert ARCH_NAMES == tuple(n for n in J_NAMES if n in ARCH_NAMES)
    assert set(NEW_ARCHS) | {'tinyllama-1.1b', 'mixtral-8x7b',
                             'deepseek-v3-671b', 'recurrentgemma-9b',
                             'mamba2-2.7b'} == set(ARCH_NAMES)


@pytest.mark.parametrize('case', CASES)
def test_param_tree_crosses_unchanged(case):
    """Same tree, shapes and dtypes as the reference's init (the encoder's
    layers and the decoder's ``norm_x``/``xattn`` included); a bf16 tree
    crosses bit for bit both ways."""
    jm, jp, tm, tp = _build(case)
    _, cfg = _cfgs(case)
    mine = tm.init(torch.Generator().manual_seed(0), 'cpu')
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(to_numpy(mine))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == b.shape and a.dtype == b.dtype
    assert param_count(mine) == sum(a.size for _, a in jl)
    jb = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    back = to_numpy(from_jax_params(jb))
    for a, b in zip(jax.tree.leaves(jb), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))
    if cfg.arch_kind == 'encdec':
        assert len(tp['encoder']['layers']) == cfg.num_encoder_layers
        assert 'xattn' in tp['blocks'][0] and 'xattn' not in \
            tp['encoder']['layers'][0]


@pytest.mark.parametrize('case', CASES)
def test_forward_matches_reference(case):
    jm, jp, tm, tp = _build(case)
    batch = _inputs(tm.cfg)
    want = jax.jit(jm.forward)(jp, batch)
    with torch.inference_mode():
        got = tm.forward(tp, _torch(batch))
    _close(got.numpy(), want)


@pytest.mark.parametrize('kv_bits', [0, 8])
@pytest.mark.parametrize('case', CASES)
def test_prefill_and_decode_match_reference(case, kv_bits):
    """Prefill logits and cache positions, then STEPS decode steps (with
    the encoder output for whisper), each step's logits against the
    reference's on its own cache."""
    jm, jp, tm, tp = _build(case, kv_bits)
    batch = _inputs(tm.cfg)
    pos0 = S + (tm.cfg.frontend_tokens if tm.cfg.arch_kind == 'vlm' else 0)
    max_len = pos0 + STEPS + 4
    jl, jc = jax.jit(functools.partial(jm.prefill, max_len=max_len))(
        jp, batch)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, _torch(batch), max_len=max_len)
    _close(tl.numpy(), jl)
    jcn, tcn = to_numpy(jax.tree.map(np.asarray, jc)), to_numpy(tc)
    assert jax.tree.structure(jcn) == jax.tree.structure(tcn)
    for a, b in zip(jcn['blocks'], tcn['blocks']):
        np.testing.assert_array_equal(b['meta']['pos'], a['meta']['pos'])
    je, te = _enc(jm, jp, tm, tp, batch)
    jstep = jax.jit(jm.decode_step)
    tok = np.array([7, 11], np.int32)
    for t in range(STEPS):
        jl, jc = jstep(jp, tok, jnp.asarray(pos0 + t, jnp.int32), jc,
                       enc=je)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(),
                                    pos0 + t, tc, enc=te)
        flips = _code_flips(jc, tc) if kv_bits else 0
        _close(tl.numpy(), jl, CODE_FLIP_TOL if flips else TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_local_ring_wraps_as_the_reference():
    """gemma3's smoke config: a 5:1 local/global pattern, window 64.  A
    prompt of 80 fills each local layer's 64-slot ring with its last 64
    positions (the global layer keeps all 80), and decode steps overwrite
    the oldest slots; the window term masks what lies outside."""
    jm, jp, tm, tp = _build('gemma3-12b')
    batch = _inputs(tm.cfg, s=80, seed=4)
    jl, jc = jax.jit(functools.partial(jm.prefill, max_len=96))(jp, batch)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, _torch(batch), max_len=96)
    _close(tl.numpy(), jl)
    local = tc['blocks'][0]
    assert local['k'].shape[2] == 64          # (G, B, slots, K, D)
    pos = local['meta']['pos'][0].numpy()
    assert sorted(pos.tolist()) == list(range(16, 80))
    assert tc['blocks'][5]['k'].shape[2] == 96
    jstep = jax.jit(jm.decode_step)
    tok = np.array([1, 2], np.int32)
    for t in range(3):
        jl, jc = jstep(jp, tok, jnp.asarray(80 + t, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(),
                                    80 + t, tc)
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(
        tc['blocks'][0]['meta']['pos'].numpy(),
        np.asarray(jc['blocks'][0]['meta']['pos']))


@pytest.mark.parametrize('case', CASES)
def test_export_lm_matches_reference(case):
    """The int8 export: every leaf bit for bit (QKV biases kept beside
    ``{'w_q', 'scale'}``, the encoder and cross-attention quantized), then
    ``fn`` (the full-sequence forward) against the reference's; an
    encoder-decoder, whose ``fn`` takes no frames in either package, is
    held through the model's forward on the exported params."""
    jm, jp, tm, tp = _build(case)
    jcfg, cfg = _cfgs(case)
    js, ts = j_export_lm(jp, jcfg), export_lm(tp, cfg)
    jq, tq = jax.tree.map(np.asarray, js.params), to_numpy(ts.params)
    assert jax.tree.structure(jq) == jax.tree.structure(tq)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(tq)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if cfg.qkv_bias:
        assert set(tq['blocks'][0]['attn']['wq']) == {'w_q', 'scale', 'b'}
    batch = _inputs(cfg)
    if cfg.arch_kind == 'encdec':
        want = jax.jit(jm.forward)(js.params, batch)
        with torch.inference_mode():
            got = tm.forward(ts.params, _torch(batch))
    else:
        want = js.fn(js.params, batch['tokens'])
        got = ts.fn(ts.params, torch.from_numpy(batch['tokens']).long())
    _close(got.numpy(), want)


def _reference_greedy(jm, jp, batch, pos0, tokens, enc=None):
    """The reference's launch/serve.py loop without the mesh (as in
    tests/test_torch_lm.py): the jitted prefill, then ``tokens`` jitted
    greedy steps from token 0 at ``pos0``."""
    max_len = pos0 + tokens + 8
    _, cache = jax.jit(functools.partial(jm.prefill, max_len=max_len))(
        jp, batch)

    @jax.jit
    def step(p, tok, cur, cache, enc):
        logits, cache = jm.decode_step(p, tok, cur, cache, enc=enc)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    tok = jnp.zeros((batch['tokens'].shape[0],), jnp.int32)
    out = []
    for t in range(tokens):
        tok, cache = step(jp, tok, jnp.asarray(pos0 + t, jnp.int32), cache,
                          enc)
        out.append(np.asarray(tok))
    return np.stack(out)


@pytest.mark.parametrize('kv_bits', [0, 8])
@pytest.mark.parametrize('case', NEW_ARCHS)
def test_serve_loop_greedy_tokens_match_reference(case, kv_bits):
    """4 greedy tokens of launch/serve.py's functions equal the reference's
    loop on the same params and prompt (a VLM's zero patches as the
    launcher gives them, decoding from prompt + patches; whisper with its
    encoder output); the plain decode attention runs once a layer a step
    and nothing launches."""
    jm, jp, tm, tp = _build(case, kv_bits)
    cfg = tm.cfg
    steps = 4
    batch = _inputs(cfg)
    extra = serve.frontend_inputs(cfg, B, 'cpu')
    if 'patches' in batch:
        batch['patches'] = extra['patches'].numpy()
    pos0 = serve.decode_start(cfg, S)
    je, te = _enc(jm, jp, tm, tp, batch)
    want = _reference_greedy(jm, jp, batch, pos0, steps, je)
    tb = _torch(batch)
    reset_counts()
    _, cache = serve.prefill_step(tm, tp, tb.pop('tokens'),
                                  max_len=pos0 + steps + 8, **tb)
    got = serve.decode(tm, tp, cache, torch.zeros(B, dtype=torch.int64),
                       pos0=pos0, tokens=steps, enc=te)
    np.testing.assert_array_equal(got.numpy(), want)
    name = 'decode_attention_int8' if kv_bits else 'decode_attention'
    assert counts()[name] == {'launches': 0,
                              'plain_calls': cfg.num_layers * steps}


def test_softcap_logits_match_the_jitted_reference():
    """gemma2's softcaps (attention 50, logits 30) in fp32: the logits of
    ``export_lm``'s ``fn`` and of ``prefill_step`` against ``jax.jit`` of
    the reference.  The port's ``layers.softcap`` divides by the cap; under
    jit XLA multiplies by fp32(1/cap).  The two rules differ by an ulp of
    the tanh argument, below the ulp by which XLA's and torch's tanh
    already differ, and both hold this tolerance, so softcap keeps the
    division (the decode kernels take the jitted rule)."""
    jm, jp, tm, tp = _build('gemma2-9b')
    jcfg, cfg = _cfgs('gemma2-9b')
    assert cfg.attn_softcap == 50.0 and cfg.logit_softcap == 30.0
    batch = _inputs(cfg, s=40, seed=9)
    js, ts = j_export_lm(jp, jcfg), export_lm(tp, cfg)
    want = js.fn(js.params, batch['tokens'])
    got = ts.fn(ts.params, torch.from_numpy(batch['tokens']).long())
    _close(got.numpy(), want)
    assert float(np.abs(np.asarray(want)).max()) <= 30.0
    jl, _ = jax.jit(functools.partial(jm.prefill, max_len=48))(jp, batch)
    logits = {}

    def keep(params, b, *, max_len):
        logits['last'], cache = tm.prefill(params, b, max_len=max_len)
        return logits['last'], cache
    probe = tm.__class__(**{**tm.__dict__, 'prefill': keep})
    serve.prefill_step(probe, tp, torch.from_numpy(batch['tokens']).long(),
                       max_len=48)
    _close(logits['last'].numpy(), jl)
