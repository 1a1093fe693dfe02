"""LM-side parity of the PyTorch port against the JAX package, on
``get_smoke_config('tinyllama-1.1b')`` (2 layers, d_model 128, 4 heads over
2 kv heads, head_dim 32, fp32).

The reference's params are converted through ``repro_torch.interop`` (the
scan-stacked ``params['blocks']`` and the ``{'prefix','blocks','tail'}``
cache cross unchanged), and the same numpy tokens go through both.
Tolerance: logits within 1e-4 x max|logit| (XLA and torch sum the matmuls
and the softmax in other orders); int8 weights and cache codes exact where
both quantize the same numbers.  On the CPU the port's decode attention
runs the kernels' plain versions; the reference's model runs its own
``decode_attn_reference`` math.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.export import export_lm as j_export_lm
from repro.data import SyntheticTokens as JTokens
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.export import export_lm
from repro_torch.data import SyntheticTokens
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.kernels import counts, reset_counts
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model, param_count

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = 'tinyllama-1.1b'
B, S, MAX_LEN, STEPS = 2, 12, 24, 3


@functools.lru_cache(maxsize=None)
def _setup(kv_bits=0):
    """(JAX model, JAX params, port model, port params, tokens)."""
    jcfg = j_get_smoke_config(ARCH).replace(kv_cache_bits=kv_bits)
    cfg = get_smoke_config(ARCH).replace(kv_cache_bits=kv_bits)
    jm = j_build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return jm, jp, build_model(cfg), from_jax_params(jp), tokens


def _close(got, want, tol=1e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def test_configs_match_reference():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(j_get_smoke_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (22, 2048, 32, 4, 64, 5632, 32000)


def test_param_tree_matches_reference():
    """Same tree, shapes and dtypes as the reference's init, full width and
    smoke, the blocks stacked (G, ...)."""
    for cfg in (get_smoke_config(ARCH),
                get_config(ARCH).replace(num_layers=2, d_model=256,
                                         d_ff=512, vocab_size=64)):
        jp = jax.eval_shape(j_build_model(
            j_get_config(ARCH).replace(**{
                f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)})).init, jax.random.key(0))
        tp = build_model(cfg).init(torch.Generator().manual_seed(0), 'cpu')
        jl = jax.tree_util.tree_flatten_with_path(jp)[0]
        tl = jax.tree_util.tree_flatten_with_path(to_numpy(tp))[0]
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert tuple(a.shape) == b.shape and a.dtype == b.dtype
        assert param_count(tp) == sum(a.size for _, a in jl)
    assert tp['blocks'][0]['attn']['wq']['w'].shape == (2, 256, 32 * 64)


def test_bf16_params_cross_bit_for_bit():
    """JAX bf16 arrays reach numpy as ml_dtypes.bfloat16; they cross as a
    uint16 view and come back with the same bits."""
    jcfg = j_get_smoke_config(ARCH).replace(dtype='bfloat16')
    jp = jax.jit(j_build_model(jcfg).init)(jax.random.key(3))
    tp = from_jax_params(jp)
    w = tp['blocks'][0]['attn']['wq']['w']
    assert w.dtype == torch.bfloat16
    jw = np.asarray(jp['blocks'][0]['attn']['wq']['w'])
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  jw.view(np.int16))
    back = to_numpy(tp)
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                              jax.tree_util.tree_flatten_with_path(back)[0]):
        a = np.asarray(a)
        assert b.dtype == a.dtype
        if a.dtype == ml_dtypes.bfloat16:
            np.testing.assert_array_equal(b.view(np.uint16),
                                          a.view(np.uint16))
    # a bf16 forward runs on the converted tree
    cfg = get_smoke_config(ARCH).replace(dtype='bfloat16')
    logits = tfm.forward(tp, cfg, torch.zeros((1, 4), dtype=torch.int64))
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 4, 512)


def test_silu_rounds_as_the_reference():
    """``layers.silu`` and its gradient against ``jax.nn.silu`` and its
    vjp under ``jax.jit`` on 100k fp32 inputs: bit for bit wherever
    ``torch.sigmoid`` and XLA's logistic agree (they differ in the last
    bit at about 0.4% of inputs), with and without a gradient to take."""
    from repro_torch.models.layers import silu
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 3).astype(np.float32)
    ct = rng.standard_normal(100_000).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.silu)(x))
    want_dx = np.asarray(jax.jit(
        lambda x, c: jax.vjp(jax.nn.silu, x)[1](c)[0])(x, ct))
    same = np.asarray(jax.jit(jax.nn.sigmoid)(x)) == \
        torch.sigmoid(torch.from_numpy(x)).numpy()
    assert same.mean() > 0.99
    xt = torch.from_numpy(x).requires_grad_()
    y = silu(xt)
    y.backward(torch.from_numpy(ct))
    assert (y.detach().numpy() == want)[same].all()
    assert (xt.grad.numpy() == want_dx)[same].all()
    with torch.no_grad():
        assert (silu(torch.from_numpy(x)).numpy() == want)[same].all()


def test_forward_matches_reference():
    jm, jp, tm, tp, tokens = _setup()
    want = jax.jit(jm.forward)(jp, {'tokens': tokens})
    got = tm.forward(tp, {'tokens': torch.from_numpy(tokens).long()})
    _close(got.numpy(), want)


@pytest.mark.parametrize('kv_bits', [0, 8])
def test_prefill_and_decode_match_reference(kv_bits):
    """Prefill logits and cache, then STEPS decode steps, each step's logits
    against the reference's on its own cache."""
    jm, jp, tm, tp, tokens = _setup(kv_bits)
    jl, jc = jax.jit(functools.partial(jm.prefill, max_len=MAX_LEN))(
        jp, {'tokens': tokens})
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {'tokens': torch.from_numpy(tokens).long()},
                            max_len=MAX_LEN)
    _close(tl.numpy(), jl)
    jcn, tcn = to_numpy(jax.tree.map(np.asarray, jc)), to_numpy(tc)
    assert jax.tree.structure(jcn) == jax.tree.structure(tcn)
    c0, t0 = jcn['blocks'][0], tcn['blocks'][0]
    np.testing.assert_array_equal(t0['meta']['pos'], c0['meta']['pos'])
    np.testing.assert_array_equal(t0['meta']['slots'], c0['meta']['slots'])
    if kv_bits:
        assert t0['k'].dtype == np.int8
        for key in ('k', 'v'):    # codes from the same k/v up to fp32 noise
            diff = np.abs(t0[key].astype(int) - c0[key].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        for key in ('k_s', 'v_s'):
            np.testing.assert_allclose(t0[key], c0[key], rtol=1e-5)
    else:
        for key in ('k', 'v'):
            _close(t0[key], c0[key], 1e-5)
    jstep = jax.jit(jm.decode_step)
    tok = np.array([7, 11], np.int32)
    for t in range(STEPS):
        jl, jc = jstep(jp, tok, jnp.asarray(S + t, jnp.int32), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), S + t,
                                    tc)
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(tc['blocks'][0]['meta']['pos'].numpy(),
                                  np.asarray(jc['blocks'][0]['meta']['pos']))


@pytest.mark.parametrize('shape', [(37, 4, 32), (8, 2, 64)])
def test_kv_quantize_matches_reference(shape):
    """int8 codes equal the reference's ``kv_quantize`` as its jitted
    prefill and serve step compute it (the scale multiplies by fp32(1/127),
    the constant divisor XLA folds), scales bit for bit; eager JAX divides,
    which moves a scale by an ulp at most and no code here."""
    x = np.random.default_rng(shape[0]).standard_normal(shape)
    x = x.astype(np.float32) * 3
    q, s = tattn.kv_quantize(torch.from_numpy(x))
    jq, js = jax.jit(j_attn.kv_quantize)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    eq, es = j_attn.kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(eq))
    np.testing.assert_allclose(s.numpy(), np.asarray(es), rtol=2e-7)
    back = tattn.kv_dequantize(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_attn.kv_dequantize(jq, js, jnp.float32)))


def test_decode_kernel_path_matches_reference_math():
    """The port's default decode attention (the kernels' plain versions on
    the CPU) against its own reference math, both writing in place."""
    _, _, tm, tp, tokens = _setup()
    with torch.inference_mode():
        _, cache = tm.prefill(tp, {'tokens': torch.from_numpy(tokens).long()},
                              max_len=MAX_LEN)
        other = jax.tree.map(lambda t: t.clone(), cache)
        tok = torch.tensor([3, 5])
        a, _ = tm.decode_step(tp, tok, S, cache)
        b, _ = tm.decode_step(tp, tok, S, other,
                              ctx={'decode_attn': tattn.decode_attn_reference})
    _close(a.numpy(), b.numpy(), 1e-5)
    for key in ('k', 'v'):
        assert torch.equal(cache['blocks'][0][key], other['blocks'][0][key])


def test_export_lm_matches_reference():
    jm, jp, tm, tp, tokens = _setup()
    jcfg = j_get_smoke_config(ARCH)
    js = j_export_lm(jp, jcfg)
    ts = export_lm(tp, get_smoke_config(ARCH))
    jq, tq = jax.tree.map(np.asarray, js.params), to_numpy(ts.params)
    assert jax.tree.structure(jq) == jax.tree.structure(tq)
    wq = tq['blocks'][0]['mlp']['wo']
    assert wq['w_q'].dtype == np.int8 and wq['w_q'].shape == (2, 256, 128)
    assert wq['scale'].shape == (2, 1, 128)
    for a, b in zip(jax.tree.leaves(jq), jax.tree.leaves(tq)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _close(ts.fn(ts.params, torch.from_numpy(tokens).long()).numpy(),
           js.fn(js.params, tokens))


def test_synthetic_tokens_match_reference():
    j, t = JTokens(vocab=512), SyntheticTokens(vocab=512)
    np.testing.assert_array_equal(t.unigram.numpy(), np.asarray(j.unigram))
    np.testing.assert_array_equal(t.rule_src.numpy(), np.asarray(j.rule_src))
    np.testing.assert_array_equal(t.rule_dst.numpy(), np.asarray(j.rule_dst))
    b = t.batch(torch.Generator().manual_seed(0), 8, 64)
    toks, labels = b['tokens'].numpy(), b['labels'].numpy()
    assert toks.shape == labels.shape == (8, 64)
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    rules = dict(zip(t.rule_src.tolist(), t.rule_dst.tolist()))
    full = np.concatenate([toks, labels[:, -1:]], axis=1)
    hits = 0
    for row in full:
        for a, nxt in zip(row[:-1], row[1:]):
            if a in rules:
                hits += 1
                assert nxt == rules[a]
    assert hits > 0


def _reference_greedy(jm, jp, prompt, tokens):
    """The reference's launch/serve.py loop, unsharded: its 1x1-mesh serve
    step does not build under the installed JAX (a sharding constraint on
    explicit mesh axes), so the same steps run without the mesh: the jitted
    prefill, then ``tokens`` jitted decode steps with a greedy argmax from
    token 0."""
    max_len = prompt.shape[1] + tokens + 8
    _, cache = jax.jit(functools.partial(jm.prefill, max_len=max_len))(
        jp, {'tokens': prompt})

    @jax.jit
    def step(p, tok, cur, cache):
        logits, cache = jm.decode_step(p, tok, cur, cache)
        return jnp.argmax(logits, -1).astype(jnp.int32), cache

    tok = jnp.zeros((prompt.shape[0],), jnp.int32)
    out = []
    for t in range(tokens):
        tok, cache = step(jp, tok, jnp.asarray(prompt.shape[1] + t,
                                               jnp.int32), cache)
        out.append(np.asarray(tok))
    return np.stack(out)


@pytest.mark.parametrize('kv_bits', [0, 8])
def test_serve_loop_greedy_tokens_match_reference(kv_bits):
    """4 greedy tokens from launch/serve.py's loop on the CPU equal the
    reference's serve loop on the same params and prompt; the plain decode
    attention runs once per layer per step and nothing launches."""
    jm, jp, tm, tp, tokens = _setup(kv_bits)
    steps = 4
    want = _reference_greedy(jm, jp, tokens, steps)
    max_len = S + steps + 8
    reset_counts()
    _, cache = serve.prefill_step(tm, tp, torch.from_numpy(tokens).long(),
                                  max_len=max_len)
    got = serve.decode(tm, tp, cache, torch.zeros(B, dtype=torch.int64),
                       pos0=S, tokens=steps)
    np.testing.assert_array_equal(got.numpy(), want)
    name = 'decode_attention_int8' if kv_bits else 'decode_attention'
    other = 'decode_attention' if kv_bits else 'decode_attention_int8'
    c = counts()
    assert c[name] == {'launches': 0, 'plain_calls': 2 * steps}
    assert c[other] == {'launches': 0, 'plain_calls': 0}


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.serve', '--smoke',
         '--tokens', '3', '--batch', '2', '--prompt-len', '8', *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_serve_cli_on_cpu_and_without_a_card():
    r = _serve_cli('--device', 'cpu', '--kv-cache-bits', '8',
                   '--int8-weights')
    assert r.returncode == 0, r.stderr
    assert 'ms/token at batch 2 (device cpu)' in r.stdout
    if not torch.cuda.is_available():
        r = _serve_cli()
        assert r.returncode != 0 and 'no CUDA device' in r.stderr
