"""MLA on its heads and the RG-LRU with its causal conv on its channels
(``models/attention.py``'s and ``models/recurrent.py``'s tensor-parallel
forms, ``models/tp.mla_tp``/``rglru_tp``) in the port's mesh steps,
against the JAX package.

* In one process, the smoke deepseek-v3-671b MLA layer (4 heads) and the
  smoke recurrentgemma-9b RG-LRU layer (128 channels) cut over a model
  axis of 4 (``mla_rank_shard``, ``rglru_rank_shard``): the four ranks'
  stages (``mla_in``/``mla_mix`` and the rows of ``wo``,
  ``mla_q``/``mla_step_out``;
  ``rglru_in``, the causal conv, ``rglru_scan``/``rglru_step``,
  ``rglru_out``) with the
  collectives done by hand summed against the whole layer and the
  reference's ``mla_forward``/``mla_decode`` and
  ``rglru_forward``/``rglru_decode`` (the latent cache, the states and
  the conv tails too), within 1e-5 x max.
* On gloo ranks (``tests/torch_tp_mla_rglru_jobs.py``; a world of 4 and
  one of 1, spawned at once, every group from a ``file://`` init method
  under the module's temporary directory with a 60 s collective timeout,
  each world joined within 150 s), against the reference's steps
  compiled on Auto-axis meshes of 4 forced host devices (a subprocess an
  arch, each started as soon as its inputs are drawn, fed the same
  params): one ``build_train_step`` step of each smoke arch on
  (1, 4): loss, grad norm and every moment leaf within 1e-4, the params
  within 0.25 x lr with the far-element rule of
  ``tests/test_torch_moe_ep.py``; each also against the gather path (the
  policy's ``tp`` None).  No leaf of a block with a tensor-parallel form
  is gathered over 'model' (recurrentgemma: no leaf at all).  Per-rank
  FLOPs (``FlopCounterMode``): the (1, 1) step's over a (1, 4) rank's
  within 5% of the reference's own ratio (recurrentgemma's of its dot
  FLOPs: XLA lowers the depthwise conv's weight gradient as a dense
  conv).  The kinds of collective over 'model' of the train, prefill and
  serve steps lie among the reference's compiled steps'.
* ``build_prefill_step`` + 3 ``build_serve_step`` tokens of each arch on
  (1, 4): the tokens equal to the gather path's and to the reference
  model's jitted single-device ones, the prefill's cache (the RG-LRU's
  states by channels, MLA's latent by sequence) and the last one within
  1e-5 x max of the reference's.

About 45 s wall with 4 cores free (the worlds are the long pole: they
start after the reference's eager inits, about 12 s, and take about 20
s; the reference's compiles run beside them); about 2 minutes beside
five other test workers.
"""
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import attention as jattn
from repro.models import recurrent as jrec
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.interop import from_jax_params
from repro_torch.models import attention as tattn
from repro_torch.models import recurrent as trec
from repro_torch.models.layers import causal_conv1d, conv1d_step, row_part
from repro_torch.models.tp import TPAxis, mla_rank_shard, rglru_rank_shard
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, 'tests', 'torch_tp_mla_rglru_jobs.py')
MLA, RGLRU = 'deepseek-v3-671b', 'recurrentgemma-9b'
ARCHS = (MLA, RGLRU)
LR = 1e-3
B, S = 4, 16
M = 4
TOL = 1e-5
RATIO_TOL = 0.05
WORLD_TIMEOUT_S = 150
SERVE = {'max_len': 16, 'steps': 3}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ one process


def _block(init, arch, seed):
    """One smoke ``arch`` block from the reference's ``init``, both
    packages."""
    lp = jax.tree.map(np.asarray, init(jax.random.key(seed),
                                       j_get_smoke_config(arch)))
    return lp, from_jax_params(lp)


def test_mla_rank_parts_sum_to_the_layer():
    """The four ranks' MLA stages, the collectives done by hand (the
    parts summed, the decode's q gathered to every head), against the
    whole layer and the reference's forward, cache write and decode
    step."""
    jcfg, cfg = j_get_smoke_config(MLA), get_smoke_config(MLA)
    jl, p = _block(jattn.init_mla, MLA, 3)
    rng = np.random.default_rng(0)
    n, cur = 24, 24
    x = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
    xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    pos = torch.arange(n, dtype=torch.int32)
    parts = [mla_rank_shard(p, r, M) for r in range(M)]
    whole, (ckv, kr) = tattn.mla_forward(p, torch.from_numpy(x), pos, cfg)
    cq, ck, krr = tattn.mla_in(p, torch.from_numpy(x), pos, cfg)
    fwd = sum(row_part(q['wo'], tattn.mla_mix(q, cq, ck, krr, pos, cfg))
              for q in parts)
    ref, (jckv, jkr) = jax.jit(partial(jattn.mla_forward, cfg=jcfg))(
        jl, jnp.asarray(x), jnp.arange(n, dtype=jnp.int32))
    for got, want in ((fwd, whole), (fwd, ref), (ck, jckv), (krr, jkr)):
        assert _rel(got, want) <= TOL
    # one decode step from that prefill's latent cache
    cache = tattn.prefill_mla_cache_write(
        tattn.init_mla_cache(cfg, 2, 32, torch.float32), ckv, kr, pos)
    jcache = jattn.prefill_mla_cache_write(
        jattn.init_mla_cache(jcfg, 2, 32, jnp.float32), jckv, jkr,
        jnp.arange(n, dtype=jnp.int32))
    w_out, _ = tattn.mla_decode(p, torch.from_numpy(xt), cur, cfg,
                                cache=_clone(cache), ctx={})
    qs = [tattn.mla_q(q, torch.from_numpy(xt), cur, cfg) for q in parts]
    new_ckv, new_kr = tattn.mla_kv_step(p, torch.from_numpy(xt), cur, cfg)
    out_lat, cache = tattn.decode_mla_reference(
        torch.cat([q[0] for q in qs], 1), torch.cat([q[1] for q in qs], 1),
        new_ckv, new_kr, cache, cur)
    hl = cfg.num_heads // M
    dec = sum(tattn.mla_step_out(parts[r], out_lat[:, r * hl:(r + 1) * hl],
                                 torch.float32) for r in range(M))
    j_out, j_cache = jax.jit(lambda p, x, c, cache: jattn.mla_decode(
        p, x, c, jcfg, cache=cache, ctx={}))(
            jl, jnp.asarray(xt), jnp.asarray(cur, jnp.int32), jcache)
    for got, want in ((dec, w_out), (dec, j_out),
                      (cache['ckv'], j_cache['ckv']),
                      (cache['kr'], j_cache['kr'])):
        assert _rel(got, want) <= TOL
    assert np.array_equal(cache['meta']['pos'].numpy(),
                          np.asarray(j_cache['meta']['pos']))


def _clone(cache):
    return {k: ({a: b.clone() for a, b in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in cache.items()}


def test_rglru_rank_parts_sum_to_the_layer():
    """The four ranks' RG-LRU stages (the conv on each rank's channels,
    its output all-gathered and the parts summed by hand) against the
    whole layer and the reference's forward and decode step; the ranks'
    states and conv tails against the whole ones."""
    jcfg, cfg = j_get_smoke_config(RGLRU), get_smoke_config(RGLRU)
    jl, p = _block(jrec.init_rglru, RGLRU, 4)
    rng = np.random.default_rng(1)
    # lam and the conv's bias drawn, so each rank's cut matters
    jl['lam'] = (2 + rng.standard_normal(jl['lam'].shape)).astype(np.float32)
    jl['conv']['b'] = (0.1 * rng.standard_normal(
        jl['conv']['b'].shape)).astype(np.float32)
    p = from_jax_params(jl)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    parts = [rglru_rank_shard(p, r, M) for r in range(M)]
    tps = [TPAxis(M, r) for r in range(M)]
    whole, st = trec.rglru_forward(p, torch.from_numpy(x), cfg,
                                   return_state=True)
    ins = [trec.rglru_in(q, torch.from_numpy(x), t)
           for q, t in zip(parts, tps)]
    us = [causal_conv1d(q['conv'], i[1]) for q, i in zip(parts, ins)]
    hs = [trec.rglru_scan(q, u, torch.cat(us, -1))
          for q, u in zip(parts, us)]
    fwd = sum(trec.rglru_out(q, h, i[0]) for q, h, i in zip(parts, hs, ins))
    k = cfg.rglru_conv
    h_parts = torch.cat([h[:, -1] for h in hs], -1)
    tail_parts = torch.cat([i[1][:, -(k - 1):] for i in ins], -1)
    ref = jax.jit(partial(jrec.rglru_forward, cfg=jcfg))(jl, jnp.asarray(x))
    for got, want in ((fwd, whole), (fwd, ref), (h_parts, st['h']),
                      (tail_parts, st['conv'])):
        assert _rel(got, want) <= TOL
    # one decode step from that state, on each rank's chunk of it
    w_out, w_cache = trec.rglru_decode(
        p, torch.from_numpy(xt), {kk: v.clone() for kk, v in st.items()},
        cfg)
    wl = cfg.rglru_width // M
    caches = [{'h': h_parts[:, r * wl:(r + 1) * wl].clone(),
               'conv': tail_parts[..., r * wl:(r + 1) * wl].clone()}
              for r in range(M)]
    ins = [trec.rglru_in(q, torch.from_numpy(xt), t)
           for q, t in zip(parts, tps)]
    steps = [conv1d_step(q['conv'], i[1], c['conv'])
             for q, i, c in zip(parts, ins, caches)]
    u_all = torch.cat([u for u, _ in steps], -1)
    dec = 0
    for q, i, c, (u, conv) in zip(parts, ins, caches, steps):
        c['conv'].copy_(conv)
        dec = dec + trec.rglru_out(q, trec.rglru_step(q, u, u_all, c['h']),
                                   i[0])
    j_out, j_cache = jax.jit(partial(jrec.rglru_decode, cfg=jcfg))(
        jl, jnp.asarray(xt), {'h': jnp.asarray(st['h'].numpy()),
                              'conv': jnp.asarray(st['conv'].numpy())})
    h_dec = torch.cat([c['h'] for c in caches], -1)
    conv_dec = torch.cat([c['conv'] for c in caches], -1)
    for got, want in ((dec, w_out), (dec, j_out), (h_dec, w_cache['h']),
                      (h_dec, j_cache['h']), (conv_dec, j_cache['conv'])):
        assert _rel(got, want) <= TOL
    # the tensor-parallel cache is the rank's chunk, as the rules cut it
    c = trec.init_rglru_cache(cfg, 2, torch.float32, tp=tps[1])
    assert c['h'].shape == (2, wl) and c['conv'].shape == (2, k - 1, wl)


# -------------------------------------------------------------- gloo ranks


REF_SCRIPT = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_smoke_config
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


def collectives(key, compiled):
    text = compiled.as_text()
    a = analyze(text)
    out[key + '/flops'] = np.float64(a['flops'])
    out[key + '/dot_flops'] = np.float64(analyze('\n'.join(
        l for l in text.splitlines() if ' convolution(' not in l))['flops'])
    for kind, n in a['collectives'].items():
        out[f'{key}/coll/{kind}'] = np.float64(n)


for arch in SET['archs']:
    cfg = get_smoke_config(arch)
    batch = {k: inp[f'{arch}/{k}'] for k in ('tokens', 'labels')}
    treedef = jax.tree.structure(jax.eval_shape(build_model(cfg).init,
                                                jax.random.key(0)))
    for shape in ((1, 4), (1, 1)):
        # the test's params; the step donates them: each step its own
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(inp[f'{arch}/init/{j}'])
            for j in range(treedef.num_leaves)])
        mesh = mesh_of(shape)
        key = f'{arch}/{shape[0]}x{shape[1]}'
        with mesh:
            fn, _, (p_aval, o_aval, _, _) = jsteps.build_train_step(
                cfg, mesh, aval(batch), lr=SET['lr'])
            compiled = fn.lower(p_aval, o_aval, aval(batch)).compile()
            p, o, m = compiled(params, adamw(SET['lr']).init(params), batch)
        collectives(key, compiled)
        if shape == (1, 1):
            continue
        out[key + '/loss'] = np.float64(m['loss'])
        out[key + '/grad_norm'] = np.float64(m['grad_norm'])
        for part, tree in (('params', p), ('mu', o.mu), ('nu', o.nu)):
            for j, x in enumerate(jax.tree.leaves(tree)):
                out[f'{key}/{part}/{j}'] = np.asarray(x)
    mesh = mesh_of((1, 4))
    b, s = SET['prompt']
    with mesh:
        toks = {'tokens': jax.ShapeDtypeStruct((b, s), jnp.int32)}
        fn, _, (p_aval, _) = jsteps.build_prefill_step(
            cfg, mesh, toks, max_len=SET['max_len'])
        collectives(f'{arch}/prefill', fn.lower(p_aval, toks).compile())
        fn, _, (avals, _) = jsteps.build_serve_step(cfg, mesh, batch=b,
                                                    max_len=SET['max_len'])
        collectives(f'{arch}/serve', fn.lower(*avals).compile())
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


def _reference_serve(arch, params, prompt):
    """The reference model's prefill and greedy decode on one device
    (jitted), each token fed back: the tokens, the prefill's cache and
    the last one."""
    model = j_build_model(j_get_smoke_config(arch))
    logits, cache = jax.jit(lambda p, t: model.prefill(
        p, {'tokens': t}, max_len=SERVE['max_len']))(params, prompt)
    first = cache
    step = jax.jit(model.decode_step)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks = [tok]
    for t in range(SERVE['steps']):
        logits, cache = step(params, tok, jnp.asarray(prompt.shape[1] + t,
                                                      jnp.int32), cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(tok)
    return np.stack([np.asarray(t) for t in toks]), first, cache


def run(d):
    """The reference's steps in a process of their own for each arch on 4
    forced host devices, each started as soon as its arch's inputs are
    drawn and run while both worlds do; the worlds' outputs, the
    reference's and the inputs."""
    import conftest
    rng = np.random.default_rng(0)
    archs, procs, logs = {}, {}, []
    try:
        for i, arch in enumerate(ARCHS):
            cfg = j_get_smoke_config(arch)
            toks = rng.integers(0, cfg.vocab_size,
                                (B, S + 1)).astype(np.int32)
            batch = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
            params = jax.tree.map(np.asarray, j_build_model(cfg).init(
                jax.random.key(i)))
            archs[arch] = {'batch': batch, 'params': params,
                           'prompt': rng.integers(0, cfg.vocab_size,
                                                  (B, 8)).astype(np.int32)}
            flat = {f'{arch}/{k}': v for k, v in batch.items()}
            flat.update({f'{arch}/init/{j}': v
                         for j, v in enumerate(jax.tree.leaves(params))})
            np.savez(os.path.join(d, f'in_{i}.npz'), **flat)
            settings = {'in': os.path.join(d, f'in_{i}.npz'),
                        'out': os.path.join(d, f'ref_{i}.npz'),
                        'archs': [arch], 'lr': LR, 'prompt': [B, 8],
                        'max_len': SERVE['max_len']}
            logs.append(open(os.path.join(d, f'ref_{i}.log'), 'w'))
            procs[arch] = subprocess.Popen(
                [sys.executable, '-c', REF_SCRIPT.replace(
                    'SETTINGS', repr(settings))],
                env=conftest.forced_device_env(4), stdout=logs[-1],
                stderr=subprocess.STDOUT, cwd=ROOT)
        torch.save({'lr': LR, 'archs': archs, 'serve': SERVE},
                   os.path.join(d, 'inputs.pt'))
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
                   OMP_NUM_THREADS='1')
        spawned = {n: _spawn_world(n, d, env) for n in (4, 1)}
        out = {n: _join(n, d, *spawned[n]) for n in (4, 1)}
        ref_serve = {a: _reference_serve(a, c['params'],
                                         jnp.asarray(c['prompt']))
                     for a, c in archs.items()}
        for p in procs.values():
            p.wait(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    ref = {}
    for i, (arch, p) in enumerate(procs.items()):
        if p.returncode != 0:
            with open(os.path.join(d, f'ref_{i}.log')) as f:
                pytest.fail(f'the reference steps of {arch} exited '
                            f'{p.returncode}:\n{f.read()[-4000:]}')
        ref.update(np.load(os.path.join(d, f'ref_{i}.npz')))
    return {'out': out, 'ref': ref, 'archs': archs, 'ref_serve': ref_serve}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    return run(str(tmp_path_factory.mktemp('tp_mla_rglru')))


def _check_step(got, ref, key, before):
    """Loss, grad norm and each moment leaf within 1e-4 (relative; the
    moments of their max); each param within 0.25 x lr of the
    reference's and moved by the step, at most 0.1% of all elements
    beyond 1e-2 x lr, each such element's reference first moment within
    1e-5 x its leaf's max (AdamW's first step moves an element whose
    gradient is float noise by up to lr either way)."""
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
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    for part in ('mu', 'nu'):
        for i, g in enumerate(got[part]):
            want = ref[f'{key}/{part}/{i}']
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale, \
                (part, i)


@pytest.mark.parametrize('arch', ARCHS)
def test_train_step_matches_reference(worlds, arch):
    before = tree_leaves(worlds['archs'][arch]['params'])
    for o in worlds['out'][4]:
        got = o['train', arch, True]
        assert got['tp']
        _check_step(got, worlds['ref'], f'{arch}/1x4', before)


@pytest.mark.parametrize('arch', ARCHS)
def test_train_step_matches_the_gather_path(worlds, arch):
    """The same step on the 'model' shards against the gather path's:
    loss and grad norm within 1e-5 relative, params within 0.25 x lr (at
    most 0.1% beyond 1e-2 x lr); no leaf of a block with a
    tensor-parallel form gathered over 'model' on the shards (none at all
    on recurrentgemma), the gather path's gathered there."""
    for o in worlds['out'][4]:
        a, b = o['train', arch, True], o['train', arch, False]
        assert abs(a['loss'] - b['loss']) <= 1e-5 * abs(b['loss'])
        assert abs(a['grad_norm'] - b['grad_norm']) <= \
            1e-5 * abs(b['grad_norm'])
        for x, y in zip(a['params'], b['params']):
            d = (x - y).abs()
            assert float(d.max()) <= 0.25 * LR
            assert float((d > 1e-2 * LR).float().mean()) <= 1e-3
        assert a['counts'].get(('gather_tp', 'model'), 0) == 0
        if arch == RGLRU:
            assert a['counts'].get(('gather', 'model'), 0) == 0
        assert a['counts'].get(('all_reduce', 'model'), 0) > 0
        assert b['counts'].get(('gather_tp', 'model'), 0) > 0


@pytest.mark.parametrize('arch', ARCHS)
def test_per_rank_flops_against_reference_ratio(worlds, arch):
    """The (1, 1) step's FLOPs over each (1, 4) rank's within 5% of the
    reference's own ratio (recurrentgemma's of its dot FLOPs); the
    gather path's ranks compute more."""
    ref = worlds['ref']
    kind = 'dot_flops' if arch == RGLRU else 'flops'
    ref_ratio = float(ref[f'{arch}/1x1/{kind}'] / ref[f'{arch}/1x4/{kind}'])
    whole = worlds['out'][1][0]['train', arch, True]['flops']
    for o in worlds['out'][4]:
        ratio = whole / o['train', arch, True]['flops']
        print(f'{arch} (1, 1) / (1, 4) FLOPs: port {ratio:.3f}, reference '
              f'{ref_ratio:.3f}')
        assert abs(ratio / ref_ratio - 1) <= RATIO_TOL, (ratio, ref_ratio)
        assert o['train', arch, False]['flops'] > \
            o['train', arch, True]['flops']


def _kinds(counts):
    return {k[0].replace('_', '-') for k, n in counts.items()
            if n and k[1] == 'model' and k[0] in ('all_reduce', 'all_gather',
                                                  'all_to_all')}


def _ref_kinds(ref, key):
    return {k.split('/')[-1] for k in ref if k.startswith(key + '/coll/')}


@pytest.mark.parametrize('arch', ARCHS)
@pytest.mark.parametrize('step', ('train', 'prefill', 'serve'))
def test_model_axis_collective_kinds_within_reference(worlds, arch, step):
    want = _ref_kinds(worlds['ref'],
                      f'{arch}/1x4' if step == 'train' else f'{arch}/{step}')
    assert want
    for o in worlds['out'][4]:
        c = (o['train', arch, True]['counts'] if step == 'train' else
             o['serve', arch, True]['counts'][step == 'serve'])
        assert _kinds(c) and _kinds(c) <= want, (_kinds(c), want)


def _caches_close(got, want, tol):
    jl = jax.tree.leaves(jax.tree.map(np.asarray, want))
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        if b.is_floating_point():
            assert _rel(b.numpy(), a) <= tol
        else:
            assert np.array_equal(b.numpy(), a)


@pytest.mark.parametrize('arch', ARCHS)
def test_prefill_and_serve_steps_on_model_shards(worlds, arch):
    """Prefill + 3 serve tokens on (1, 4): tokens equal to the gather
    path's and to the reference's single-device ones, the caches within
    1e-5 x max of the reference's; no leaf of a block with a
    tensor-parallel form gathered over 'model'."""
    toks, first, last = worlds['ref_serve'][arch]
    for o in worlds['out'][4]:
        tp, gather = o['serve', arch, True], o['serve', arch, False]
        assert np.array_equal(tp['tokens'].numpy(), toks)
        assert np.array_equal(gather['tokens'].numpy(), toks)
        _caches_close(tp['prefill_cache'], first, TOL)
        _caches_close(tp['cache'], last, TOL)
        for c in tp['counts']:
            assert c.get(('gather_tp', 'model'), 0) == 0
