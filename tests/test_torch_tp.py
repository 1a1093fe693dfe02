"""Tensor-parallel compute on 'model' in the port's mesh steps
(``models/tp.py``, ``models/actsharding.py``'s gather, ``launch/steps.py``)
against the JAX package.

* In one process, tinyllama's smoke layer at 4 kv heads cut over a model
  axis of 4 (``TPAxis`` without a group, one rank at a time): the sum of
  the four rank-local attention and MLP parts (``gqa_partial``,
  ``mlp_partial``, before the all-reduce) against the whole layer and the
  reference's ``gqa_forward``/``mlp`` on the same params, the four
  vocab-parallel embedding parts against the lookup, and the cross-entropy
  from four vocab chunks' parts against ``log_softmax``.
* On gloo ranks (``tests/torch_tp_jobs.py``; a world of 4 and one of 1,
  spawned once for the module at the same time, every group from a
  ``file://`` init method under the module's temporary directory with a
  60 s collective timeout, each world joined within 150 s), one
  ``build_train_step`` step of the smoke tinyllama (fp32) on (1, 4), where
  'model' cuts each of its 2 kv heads of 32 in two, at 4 kv heads on
  (1, 4) (one a rank), and on (2, 2), each against the reference's
  ``build_train_step`` on the same mesh of forced host devices (a
  subprocess started first): loss, grad norm and every moment leaf within
  1e-4 (relative; the moments of their max), the params within 0.25 x lr
  and at most 0.1% of them beyond 1e-2 x lr (AdamW's first step, as
  ``tests/test_torch_mesh.py`` holds it).  The policy's counts: no leaf of
  the attention, the MLP or the vocab tables gathered over 'model', the
  step all-reducing over 'model', k/v gathered over 'model' only where
  'model' cuts a kv head; with ``tp=False`` (every leaf gathered whole)
  the same leaves gathered over 'model'.  Per-rank FLOPs
  (``FlopCounterMode``): the (1, 1) step's over the (1, 4) step's at least
  3.6, beside the reference's own ratio from ``hlo_analysis.analyze`` on
  its compiled steps (4.00).
* ``build_prefill_step`` + 3 steps of ``build_serve_step`` on (1, 4)
  (fp32 and int8 caches, long_ctx at batch 1) on the 'model' shards:
  the tokens equal to the gather path's and to the reference model's
  jitted single-device tokens, the caches within 1e-5 x max of the
  gather path's.
* Other archs on (1, 4), the reference's weights loaded with
  ``from_jax_params``: a train step of whisper-small (heads whole on
  every rank, ``wo`` by rows, cross-attention), gemma2-9b (softcaps, a
  tied vocab-parallel unembedding, local layers), deepseek-v3-671b (MLA
  on its heads, the MoE expert-parallel, its shared expert on shards) and
  recurrentgemma-9b (the RG-LRU on its channels, its one kv head cut by
  'model', its MLP on shards) against the reference's
  step on the same mesh, at the bounds above (the params' far elements
  counted over the whole tree, each with a first moment of float noise,
  as ``tests/test_torch_moe_ep.py`` holds them); 3 serve tokens with the
  reference's int8 weights (the scales cut to the rank's columns) of
  tinyllama and whisper against the reference's
  ``build_serve_step(int8_weights=True)``.  Each also against the gather
  path (the policy's ``tp`` set to None: every leaf gathered whole), a
  second check.
* The collectives over 'model': the kinds the port's (1, 4) train,
  prefill and serve steps run are among those the reference's compiled
  steps run (``hlo_analysis.analyze``).  ``python tests/test_torch_tp.py``
  prints both sides' operand bytes by kind.

About 45 s on one core, most of it the reference's compiles, which run
beside the worlds.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core.quantization import \
    quantize_params_for_serving as j_quantize_params_for_serving
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.interop import from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.tp import (TPAxis, ce_from_parts, rank_shard,
                                   vocab_ce_parts, vocab_embed)
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, 'tests', 'torch_tp_jobs.py')
ARCH = 'tinyllama-1.1b'
LR = 1e-3
B, S = 8, 32
WORLD_TIMEOUT_S = 150
#: the train cases: config overrides
CASES = {'cut': {}, 'whole': {'num_kv_heads': 4}}
#: (mesh, case) of each port step held against the reference's
STEPS = (((1, 4), 'cut'), ((1, 4), 'whole'), ((2, 2), 'cut'))
#: archs whose (1, 4) train step on the 'model' shards is held against
#: the reference's: whisper's heads whole on every rank (shard_heads off)
#: with ``wo`` by rows and cross-attention, gemma2's softcaps, tied
#: unembedding and local layers, deepseek's MLA (on its heads) and MoE,
#: recurrentgemma's RG-LRU (on its channels) beside its MLP
ARCHS = ('whisper-small', 'gemma2-9b', 'deepseek-v3-671b',
         'recurrentgemma-9b')
#: archs served with int8 weights on (1, 4)
INT8 = ('tinyllama-1.1b', 'whisper-small')
AB, AS = 4, 16          # the other archs' batch
#: the serve cases: (name, kv cache bits, long_ctx, batch)
SERVE = (('kv0', 0, False, 4), ('kv8', 8, False, 4), ('long-ctx', 0, True, 1))


# ------------------------------------------------------------ one process


def _layer_parts(p, cfg, m):
    """Each rank's attention and MLP dicts of a whole smoke layer."""
    out = []
    for r in range(m):
        a = {n: rank_shard(p['attn'][n], 'col', r, m)
             for n in ('wq', 'wk', 'wv')}
        a['wo'] = rank_shard(p['attn']['wo'], 'row', r, m)
        f = {n: rank_shard(p['mlp'][n], 'col', r, m) for n in ('wi', 'wg')}
        f['wo'] = rank_shard(p['mlp']['wo'], 'row', r, m)
        out.append((a, f))
    return out


def test_rank_local_parts_sum_to_the_layer():
    """The four rank-local parts before the all-reduce sum to the whole
    attention and MLP (and to the reference's), the vocab-parallel
    embedding's parts to the lookup and the cross-entropy's chunk parts
    to ``log_softmax``'s."""
    m = 4
    jcfg = j_get_smoke_config(ARCH).replace(num_kv_heads=4)
    cfg = get_smoke_config(ARCH).replace(num_kv_heads=4)
    jp = j_build_model(jcfg).init(jax.random.key(1))
    p = from_jax_params(jp)
    lp = {'attn': {k: v for k, v in p['blocks'][0]['attn'].items()},
          'mlp': p['blocks'][0]['mlp']}
    lp = {k: {n: {t: w[0] for t, w in d.items()} for n, d in v.items()}
          for k, v in lp.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    pos = torch.arange(S, dtype=torch.int32)
    whole_a, _ = tattn.gqa_forward(lp['attn'], xt, pos, cfg, kind='global')
    whole_f = tlayers.mlp(lp['mlp'], xt)
    parts_a = parts_f = 0
    for r, (a, f) in enumerate(_layer_parts(lp, cfg, m)):
        tp = TPAxis(m, r)
        pa, (k, _) = tattn.gqa_partial(a, xt, pos, cfg, kind='global', tp=tp)
        assert k.shape[2] == cfg.num_kv_heads // m
        parts_a = parts_a + pa
        parts_f = parts_f + tlayers.mlp_partial(f, xt, tp)
    jl = jax.tree.map(lambda w: w[0], jp['blocks'][0])
    ref_a, _ = jattn.gqa_forward(jl['attn'], jnp.asarray(x),
                                 jnp.arange(S, dtype=jnp.int32), jcfg,
                                 kind='global')
    ref_f = jlayers.mlp(jl['mlp'], jnp.asarray(x))
    for got, whole, ref in ((parts_a, whole_a, ref_a),
                            (parts_f, whole_f, ref_f)):
        scale = float(whole.abs().max())
        assert float((got - whole).abs().max()) <= 1e-5 * scale
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) <= \
            1e-5 * scale
    table = p['embed']['table']
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    emb = sum(vocab_embed(rank_shard(p['embed'], 'vocab', r, m)['table'],
                          toks, torch.float32, TPAxis(m, r))
              for r in range(m))
    assert torch.equal(emb, table[toks])
    logits = torch.from_numpy(rng.standard_normal(
        (2, S, cfg.vocab_size)).astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S)))
    n = cfg.vocab_size // m
    chunks = [logits[..., r * n:(r + 1) * n] for r in range(m)]
    mx = torch.stack([c.amax(-1) for c in chunks]).amax(0)
    s = t = 0
    for r, c in enumerate(chunks):
        sr, tr = vocab_ce_parts(c, labels, r * n, mx)
        s, t = s + sr, t + tr
    want = -torch.gather(torch.log_softmax(logits, -1), -1,
                         labels[..., None])[..., 0].mean()
    assert abs(float(ce_from_parts(s, t, mx)) - float(want)) <= \
        1e-6 * abs(float(want))


# -------------------------------------------------------------- gloo ranks


REF_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.core.quantization import quantize_params_for_serving
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze
from repro.models.model import build_model
from repro.optim import adamw
SET = SETTINGS
inp = dict(np.load(SET['in']))
out = {}


def mesh_of(shape):
    return jax.make_mesh(shape, ('data', 'model'),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])


def aval(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


def batch_of(prefix):
    return {k[len(prefix) + 1:]: v for k, v in inp.items()
            if k.startswith(prefix + '/')}


def collectives(key, compiled):
    a = analyze(compiled.as_text())
    out[key + '/flops'] = np.float64(a['flops'])
    for kind, n in a['collectives'].items():
        out[f'{key}/coll/{kind}'] = np.float64(n)


def train(key, cfg, shape, batch):
    mesh = mesh_of(shape)
    params = build_model(cfg).init(jax.random.key(0))
    with mesh:
        fn, _, (p_aval, o_aval, _, _) = jsteps.build_train_step(
            cfg, mesh, aval(batch), lr=SET['lr'])
        compiled = fn.lower(p_aval, o_aval, aval(batch)).compile()
        p, o, m = compiled(params, adamw(SET['lr']).init(params), batch)
    collectives(key, compiled)
    out[key + '/loss'] = np.float64(m['loss'])
    out[key + '/grad_norm'] = np.float64(m['grad_norm'])
    for part, tree in (('params', p), ('mu', o.mu), ('nu', o.nu)):
        for i, x in enumerate(jax.tree.leaves(tree)):
            out[f'{key}/{part}/{i}'] = np.asarray(x)


for shape, case in SET['steps']:
    train(f'{shape[0]}x{shape[1]}/{case}', get_smoke_config(
        SET['arch']).replace(**SET['cases'][case]), shape,
        batch_of(SET['arch']))
for arch in SET['archs']:
    train(arch, get_smoke_config(arch), (1, 4), batch_of(arch))
mesh = mesh_of((1, 4))
cfg = get_smoke_config(SET['arch'])
with mesh:
    for name, b, s, long_ctx in SET['serve']:
        toks = {'tokens': jax.ShapeDtypeStruct((b, s), jnp.int32)}
        fn, _, (p_aval, _) = jsteps.build_prefill_step(cfg, mesh, toks,
                                                       max_len=16)
        collectives(f'prefill/{name}', fn.lower(p_aval, toks).compile())
        fn, _, (avals, _) = jsteps.build_serve_step(
            cfg, mesh, batch=b, max_len=16, long_ctx=long_ctx)
        collectives(f'serve/{name}', fn.lower(*avals).compile())
for arch in SET['int8']:
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    q = quantize_params_for_serving(params)
    batch = batch_of('int8/' + arch)
    toks = jnp.asarray(batch['tokens'])
    b = toks.shape[0]
    enc = ([model.encode(params, jnp.asarray(batch['frames']))]
           if 'frames' in batch else [])
    with mesh:
        step, _, _ = jsteps.build_serve_step(cfg, mesh, batch=b, max_len=16,
                                             int8_weights=True)
        cache = model.init_cache(b, 16)
        tok, got = toks[:, 0], []
        for t in range(3):
            tok, cache = step(q, tok, jnp.asarray(t, jnp.int32), cache, *enc)
            got.append(np.asarray(tok))
    out[f'int8/{arch}/tokens'] = np.stack(got)
np.savez(SET['out'], **out)
"""


def _spawn_world(n, d, env):
    logs = [open(os.path.join(d, f'log_{n}_{r}.txt'), 'w')
            for r in range(n)]
    procs = [subprocess.Popen([sys.executable, JOBS, d, str(r), str(n)],
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(n)]
    return procs, logs


def _join(n, d, procs, logs):
    try:
        for p in procs:
            p.wait(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(d, f'log_{n}_{r}.txt')) as f:
                pytest.fail(f'world {n} rank {r} exited {p.returncode}:\n'
                            f'{f.read()[-4000:]}')
    return [torch.load(os.path.join(d, f'out_{n}_{r}.pt'),
                       weights_only=False) for r in range(n)]


def _reference_serve(params, case):
    """The reference model's prefill and greedy decode on one device
    (jitted, its plain decode math), each token fed back."""
    cfg = j_get_smoke_config(ARCH).replace(kv_cache_bits=case['bits'])
    model = j_build_model(cfg)
    prompt = jnp.asarray(case['prompt'])
    logits, cache = jax.jit(lambda p, t: model.prefill(
        p, {'tokens': t}, max_len=case['max_len']))(params, prompt)
    step = jax.jit(model.decode_step)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [tok]
    for t in range(case['steps']):
        logits, cache = step(params, tok, jnp.asarray(prompt.shape[1] + t,
                                                      jnp.int32), cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(tok)
    return np.stack([np.asarray(t) for t in toks])


def _arch_batch(arch, rng):
    """A batch of ``AB`` x ``AS`` tokens (and whisper's frames)."""
    cfg = j_get_smoke_config(arch)
    toks = rng.integers(0, cfg.vocab_size, (AB, AS + 1)).astype(np.int32)
    batch = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
    if cfg.arch_kind == 'encdec':
        batch['frames'] = rng.standard_normal(
            (AB, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def run(d):
    """The reference's steps, in their own process on 4 forced host
    devices, started first and run while both worlds do; the worlds'
    outputs and the reference's, with the inputs."""
    import conftest
    rng = np.random.default_rng(0)
    jcfg = j_get_smoke_config(ARCH)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
    arch_batch = {a: _arch_batch(a, rng) for a in ARCHS + INT8
                  if a != ARCH}
    arch_batch[ARCH] = {k: v[:AB, :AS] for k, v in batch.items()}
    np.savez(os.path.join(d, 'batch.npz'), **{
        f'{a}/{k}': v for a, bt in [(ARCH, batch)] + [
            (a, arch_batch[a]) for a in ARCHS] + [
            (f'int8/{a}', arch_batch[a]) for a in INT8]
        for k, v in bt.items()})
    settings = {'in': os.path.join(d, 'batch.npz'),
                'out': os.path.join(d, 'ref.npz'), 'arch': ARCH,
                'lr': LR, 'steps': [list(x) for x in STEPS]
                + [[(1, 1), 'cut']],
                'cases': CASES, 'archs': list(ARCHS), 'int8': list(INT8),
                'serve': [(n, b, 8, lc) for n, bits, lc, b in SERVE
                          if not bits]}
    # two processes: the tinyllama steps with the serve steps' collectives,
    # and the other archs with the int8 serve steps
    parts = ({**settings, 'archs': [], 'int8': [], 'out': settings['out']
              + '.a.npz'},
             {**settings, 'steps': [], 'serve': [], 'out': settings['out']
              + '.b.npz'})
    refs = []
    for i, part in enumerate(parts):
        log = open(os.path.join(d, f'ref_{i}.log'), 'w')
        refs.append((subprocess.Popen(
            [sys.executable, '-c', REF_SCRIPT.replace('SETTINGS',
                                                      repr(part))],
            env=conftest.forced_device_env(4), stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT), log))
    try:
        train = {c: {'cfg': over, 'params': jax.tree.map(
            np.asarray, j_build_model(jcfg.replace(**over)).init(
                jax.random.key(0)))} for c, over in CASES.items()}
        serve = {name: {'bits': bits, 'long_ctx': long_ctx, 'max_len': 16,
                        'steps': 3, 'prompt': rng.integers(
                            0, jcfg.vocab_size, (b, 8)).astype(np.int32)}
                 for name, bits, long_ctx, b in SERVE}
        params = {a: jax.tree.map(np.asarray, j_build_model(
            j_get_smoke_config(a)).init(jax.random.key(0)))
            for a in ARCHS + INT8}
        int8 = {a: {'params': params[a], 'q': jax.tree.map(
            np.asarray, j_quantize_params_for_serving(params[a])),
            'tokens': arch_batch[a]['tokens'],
            **({'frames': arch_batch[a]['frames']}
               if 'frames' in arch_batch[a] else {})} for a in INT8}
        torch.save({'arch': ARCH, 'lr': LR, 'batch': batch, 'train': train,
                    'serve': serve, 'int8': int8,
                    'archs': {a: {'params': params[a],
                                  'batch': arch_batch[a]} for a in ARCHS}},
                   os.path.join(d, 'inputs.pt'))
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
                   OMP_NUM_THREADS='1')
        spawned = {n: _spawn_world(n, d, env) for n in (4, 1)}
        out = {n: _join(n, d, *spawned[n]) for n in (4, 1)}
        ref_serve = {k: _reference_serve(train['cut']['params'], c)
                     for k, c in serve.items()}
        for proc, _ in refs:
            proc.wait(timeout=300)
    finally:
        for proc, log in refs:
            if proc.poll() is None:
                proc.kill()
            log.close()
    ref = {}
    for i, (part, (proc, _)) in enumerate(zip(parts, refs)):
        if proc.returncode != 0:
            with open(os.path.join(d, f'ref_{i}.log')) as f:
                pytest.fail(f'the reference steps exited {proc.returncode}:'
                            f'\n{f.read()[-4000:]}')
        ref.update(np.load(part['out']))
    return {'out': out, 'ref': ref,
            'train': train, 'ref_serve': ref_serve, 'serve': serve,
            'params': params}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    return run(str(tmp_path_factory.mktemp('tp')))


def _rank_outs(worlds, key):
    n = 1 if key[1] == (1, 1) else 4
    return [o[key] for o in worlds['out'][n]]


def _check_step(got, ref, key, before):
    """A port step's ``got`` (loss, grad norm, params, moments) against
    the reference's under ``key``: loss, grad norm and each moment leaf
    within 1e-4 (relative; the moments of their max), each param within
    0.25 x lr of the reference's and moved by the step, at most 0.1% of
    all elements beyond 1e-2 x lr, each such element's reference first
    moment within 1e-5 x its leaf's max (AdamW's first step moves an
    element whose gradient is float noise by up to lr either way)."""
    for name in ('loss', 'grad_norm'):
        want = float(ref[f'{key}/{name}'])
        assert abs(got[name] - want) <= 1e-4 * abs(want), name
    assert len(got['params']) == len(before)
    n_far = n_all = 0
    for i, (g, b) in enumerate(zip(got['params'], before)):
        want, mu = ref[f'{key}/params/{i}'], ref[f'{key}/mu/{i}']
        g = g.numpy()
        assert g.shape == want.shape, i
        d = np.abs(g - want)
        assert float(d.max()) <= 0.25 * LR, i
        far = d > 1e-2 * LR
        assert (np.abs(mu[far]) <= 1e-5 * np.abs(mu).max()).all(), i
        n_far, n_all = n_far + int(far.sum()), n_all + far.size
        assert (g != b).any(), i
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    for part in ('mu', 'nu'):
        for i, g in enumerate(got[part]):
            want = ref[f'{key}/{part}/{i}']
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale, \
                (part, i)


@pytest.mark.parametrize('shape,case', STEPS,
                         ids=[f'{a}x{b}-{c}' for (a, b), c in STEPS])
def test_train_step_matches_reference(worlds, shape, case):
    ref, key = worlds['ref'], f'{shape[0]}x{shape[1]}/{case}'
    before = tree_leaves(worlds['train'][case]['params'])
    for o in _rank_outs(worlds, ('train', shape, case)):
        assert o['tp']
        _check_step(o, ref, key, before)


@pytest.mark.parametrize('case', ('cut', 'whole'))
def test_model_axis_traffic(worlds, case):
    """On (1, 4) no leaf of the attention, the MLP or the vocab tables is
    gathered over 'model'; the step all-reduces over 'model'; k/v are
    gathered over 'model' only where 'model' cuts a kv head (2 heads of
    32 over 4 ranks, not 4 heads).  The gather path gathers those leaves
    over 'model' and all-reduces nothing there."""
    for o in _rank_outs(worlds, ('train', (1, 4), case)):
        c = o['counts']
        assert c.get(('gather_tp', 'model'), 0) == 0
        assert c.get(('all_reduce', 'model'), 0) > 0
        if case == 'cut':
            assert c.get(('all_gather', 'model'), 0) > 0
        else:
            assert c.get(('all_gather', 'model'), 0) == 0
    for o in _rank_outs(worlds, ('train', (1, 4), 'gather')):
        assert not o['tp']
        assert o['counts'].get(('gather_tp', 'model'), 0) > 0
        assert o['counts'].get(('all_reduce', 'model'), 0) == 0


def _kinds(counts):
    """The collective kinds run over 'model' (hlo_analysis's names)."""
    return {k[0].replace('_', '-') for k, n in counts.items()
            if n and k[1] == 'model' and k[0] in ('all_reduce', 'all_gather')}


def _ref_kinds(ref, key):
    return {k.split('/')[-1] for k in ref if k.startswith(key + '/coll/')}


#: (step, case) whose collectives over 'model' are read on both sides
KINDS = (('train', 'cut'), ('train', 'whole'), ('prefill', 'kv0'),
         ('serve', 'kv0'), ('prefill', 'long-ctx'), ('serve', 'long-ctx'))


def _port_counts(worlds, step, case):
    """Each rank's counts of a (1, 4) step."""
    if step == 'train':
        return [o['counts'] for o in _rank_outs(worlds,
                                                 ('train', (1, 4), case))]
    i = 0 if step == 'prefill' else 1
    return [o['serve', True][case]['counts'][i] for o in worlds['out'][4]]


@pytest.mark.parametrize('step,case', KINDS,
                         ids=[f'{s}-{c}' for s, c in KINDS])
def test_model_axis_collective_kinds_within_reference(worlds, step, case):
    """The kinds of collective the port's (1, 4) step runs over 'model'
    are among those of the reference's compiled step on the same mesh
    (all-reduces of activations where GSPMD all-reduces, no all-gather
    where it runs none)."""
    key = f'1x4/{case}' if step == 'train' else f'{step}/{case}'
    want = _ref_kinds(worlds['ref'], key)
    assert want
    for c in _port_counts(worlds, step, case):
        assert _kinds(c) and _kinds(c) <= want, (_kinds(c), want)


def test_per_rank_flops_quarter_on_model_4(worlds):
    """The (1, 1) step's FLOPs over each (1, 4) rank's: at least 3.6 (the
    reference's ``analyze`` gives 4.00 on its compiled steps); the gather
    path's ranks each compute the whole step."""
    ref = worlds['ref']
    ref_ratio = float(ref['1x1/cut/flops'] / ref['1x4/cut/flops'])
    assert abs(ref_ratio - 4.0) <= 0.05
    whole = _rank_outs(worlds, ('train', (1, 1), 'cut'))[0]['flops']
    for o in _rank_outs(worlds, ('train', (1, 4), 'cut')):
        assert whole / o['flops'] >= 3.6, (whole, o['flops'], ref_ratio)
    for o in _rank_outs(worlds, ('train', (1, 4), 'gather')):
        assert o['flops'] == whole


@pytest.mark.parametrize('case', [c[0] for c in SERVE])
def test_prefill_and_serve_steps_on_model_shards(worlds, case):
    """``build_prefill_step`` + 3 ``build_serve_step`` tokens on (1, 4):
    the tokens equal to the gather path's and to the reference's
    single-device ones, the caches within 1e-5 x max of the gather
    path's; the embedding, MLP and attention all-reduce over 'model',
    and no TP leaf is gathered over 'model'."""
    want = worlds['ref_serve'][case]
    for o in worlds['out'][4]:
        tp, gather = o['serve', True][case], o['serve', False][case]
        assert np.array_equal(tp['tokens'].numpy(), want)
        assert np.array_equal(gather['tokens'].numpy(), want)
        for got, g in zip(tree_leaves(tp['cache']),
                          tree_leaves(gather['cache'])):
            if got.is_floating_point():
                scale = max(float(g.abs().max()), 1e-30)
                assert float((got - g).abs().max()) <= 1e-5 * scale
            else:
                assert torch.equal(got, g)
        for c in tp['counts']:
            assert c.get(('gather_tp', 'model'), 0) == 0
            assert c.get(('all_reduce', 'model'), 0) > 0


@pytest.mark.parametrize('arch', ARCHS)
def test_other_archs_match_reference(worlds, arch):
    """One (1, 4) train step of each arch on the 'model' shards, the
    reference's weights, against the reference's step on the same mesh
    (:func:`_check_step`); the leaves with a tensor-parallel form kept on
    their shards (MLA's and the RG-LRU's too)."""
    before = tree_leaves(worlds['params'][arch])
    for o in worlds['out'][4]:
        got = o['archs']['train', arch, True]
        _check_step(got, worlds['ref'], arch, before)
        assert got['counts'].get(('all_reduce', 'model'), 0) > 0
        assert got['counts'].get(('gather_tp', 'model'), 0) == 0


@pytest.mark.parametrize('arch', ARCHS)
def test_other_archs_match_the_gather_path(worlds, arch):
    """The same step on the 'model' shards against the gather path's (a
    second check beside the reference): loss and grad norm within 1e-5
    relative, params within 0.25 x lr (at most 0.1% beyond 1e-2 x lr)."""
    for o in worlds['out'][4]:
        a, b = (o['archs']['train', arch, tp] for tp in (True, False))
        assert abs(a['loss'] - b['loss']) <= 1e-5 * abs(b['loss'])
        assert abs(a['grad_norm'] - b['grad_norm']) <= \
            1e-5 * abs(b['grad_norm'])
        for x, y in zip(a['params'], b['params']):
            d = (x - y).abs()
            assert float(d.max()) <= 0.25 * LR
            assert float((d > 1e-2 * LR).float().mean()) <= 1e-3


@pytest.mark.parametrize('arch', INT8)
def test_int8_serve_step_on_model_shards(worlds, arch):
    """``build_serve_step(int8_weights=True)`` on (1, 4), the reference's
    int8 weights: 3 greedy tokens on the 'model' shards (the int8 scales
    cut to the rank's columns) equal to the reference's own (1, 4) step's
    and to the gather path's."""
    want = worlds['ref'][f'int8/{arch}/tokens']
    for o in worlds['out'][4]:
        (ta, ca), (tb, _) = (o['archs']['int8', arch, tp]
                             for tp in (True, False))
        assert np.array_equal(ta.numpy(), want)
        assert torch.equal(ta, tb)
        assert ca.get(('gather_tp', 'model'), 0) == 0
        assert ca.get(('all_reduce', 'model'), 0) > 0


if __name__ == '__main__':
    # the operand bytes over 'model' by kind of each (1, 4) step, the
    # port's rank 0 (a serve step's over its 3 calls, as one) beside the
    # reference's compiled step's
    import tempfile
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        w = run(d)
    for step, case in KINDS:
        key = f'1x4/{case}' if step == 'train' else f'{step}/{case}'
        c = _port_counts(w, step, case)[0]
        div = 3 if step == 'serve' else 1
        port = {k[0][:-6].replace('_', '-'): n / div for k, n in c.items()
                if k[0].endswith('_bytes') and k[1] == 'model'}
        ref = {k: float(w['ref'][f'{key}/coll/{k}'])
               for k in _ref_kinds(w['ref'], key)}
        print(f'{step} {case}: port {port} reference {ref}')
