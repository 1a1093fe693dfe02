"""Mamba-2's SSD block on its 'model' shards (``models/recurrent.py``'s
tensor-parallel form, ``models/tp.ssm_tp``), the split weight gradient of
a table whole on 'model' (``tp.whole_table_product``) and the prefill that
builds only each rank's chunk of the cache (``launch/steps.py``,
``launch/serving.make_prefill_ctx``), against the JAX package.

* In one process, the smoke mamba2-2.7b layer (16 heads of 16, state 16,
  ``in_proj`` 560 columns) cut over a model axis of 4 by heads
  (``mamba2_rank_shard``): the four ranks' stages (``ssm_in``,
  ``ssm_mix``/``ssm_step``, ``ssm_out``) with the collectives done by hand
  summed against the whole layer and the reference's ``mamba2_forward``
  and ``mamba2_decode`` (the state and the conv tail too), within 1e-5 x
  max.
* On gloo ranks (``tests/torch_tp_ssm_jobs.py``; a world of 4 and one of
  1, spawned at once, every group from a ``file://`` init method under
  the module's temporary directory with a 60 s collective timeout, each
  world joined within 150 s), against the reference's steps compiled on
  an Auto-axis mesh of 4 forced host devices (a subprocess started
  first): one ``build_train_step`` step of the smoke mamba2-2.7b on (1,
  4) and of the smoke tinyllama at a vocab of 510 (the table whole on
  'model': its weight gradient split by columns over 'model'): loss, grad
  norm and every moment leaf within 1e-4, the params within 0.25 x lr
  with the far-element rule of ``tests/test_torch_moe_ep.py``; each also
  against the gather path (the policy's ``tp`` None).  No leaf of the
  Mamba-2 block is gathered over 'model'.  Per-rank FLOPs
  (``FlopCounterMode``): the (1, 1) step's over a (1, 4) rank's at least
  3.6 (the reference's own ratio printed beside it); the odd-vocab step
  below its gather path's.  The kinds of collective over 'model' of the
  train, prefill and serve steps lie among the reference's compiled
  steps'.
* ``build_prefill_step`` + 3 ``build_serve_step`` tokens of mamba2 on (1,
  4): the tokens equal to the gather path's and to the reference model's
  jitted single-device ones, the prefill's cache (the states by heads)
  and the last one within 1e-5 x max of the reference's.
* The prefill of the smoke tinyllama and gemma2 (a local ring of 16
  slots under a 40-token prompt: the ring wraps), fp32 and int8 caches,
  built as each rank's chunk of the cache: every cache DTensor's full
  tensor equal, element for element, to the one the prefill built whole
  and cut afterwards (its ctx emptied), the tokens equal.

About 40 s wall (the reference's compiles in their subprocess are the
long pole; the worlds take about 10 s beside them).
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
from repro.models import recurrent as jrec
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.interop import from_jax_params
from repro_torch.models import recurrent as trec
from repro_torch.models.tp import TPAxis
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, 'tests', 'torch_tp_ssm_jobs.py')
ARCH = 'mamba2-2.7b'
LR = 1e-3
B, S = 4, 16
M = 4
TOL = 1e-5
WORLD_TIMEOUT_S = 150
#: the train cases: (arch, config overrides)
CASES = {'ssm': (ARCH, {}),
         'vocab': ('tinyllama-1.1b', {'vocab_size': 510})}
#: the chunked-prefill cases: (arch, overrides, kv cache bits)
PREFILL = {f'{a}/kv{bits}': (a, over, bits)
           for a, over in (('tinyllama-1.1b', {}),
                           ('gemma2-9b', {'window': 16}))
           for bits in (0, 8)}
SERVE = {'max_len': 16, 'steps': 3}


# ------------------------------------------------------------ one process


def _layer(cfg_j, seed):
    """The smoke layer's Mamba-2 params (the reference's init with its
    per-head leaves and the norm's scale drawn, so each rank's cut
    matters), both packages."""
    jp = j_build_model(cfg_j).init(jax.random.key(seed))
    lp = jax.tree.map(lambda w: np.asarray(w[0]), jp['blocks'][0]['mamba'])
    rng = np.random.default_rng(seed)
    for k, s in (('A_log', 0.5), ('D', 1.0), ('dt_bias', 0.5)):
        lp[k] = (s * rng.standard_normal(lp[k].shape)).astype(np.float32)
    lp['norm']['scale'] = (1 + 0.1 * rng.standard_normal(
        lp['norm']['scale'].shape)).astype(np.float32)
    lp['conv']['b'] = (0.1 * rng.standard_normal(
        lp['conv']['b'].shape)).astype(np.float32)
    return lp, from_jax_params(lp)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_rank_parts_sum_to_the_layer():
    """The four ranks' stages, the collectives done by hand, against the
    whole layer and the reference's forward and decode step."""
    jcfg, cfg = j_get_smoke_config(ARCH), get_smoke_config(ARCH)
    jl, p = _layer(jcfg, 3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    xt = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    parts = [trec.mamba2_rank_shard(p, r, M) for r in range(M)]
    tps = [TPAxis(M, r) for r in range(M)]
    conv = {k: torch.cat([q['conv'][k] for q in parts], -1)
            for k in p['conv']}

    def gathered(xs):
        return torch.cat([trec.ssm_in(parts[r], xs, tps[r])
                          for r in range(M)], -1)

    def summed(outs):
        ss = sum(o[1] for o in outs)
        return sum(trec.ssm_out(parts[r], outs[r][0], ss, cfg)
                   for r in range(M))
    whole, (h, tail) = trec.mamba2_forward(p, torch.from_numpy(x), cfg,
                                           return_state=True)
    mix = [trec.ssm_mix(parts[r], gathered(torch.from_numpy(x)), conv, cfg,
                        tps[r], return_state=True) for r in range(M)]
    ref, (jh, jtail) = jrec.mamba2_forward(jl, jnp.asarray(x), jcfg,
                                           return_state=True)
    h_parts = torch.cat([o[2][0] for o in mix], 1)
    tail_parts = torch.cat([o[2][1] for o in mix], -1)
    for got, want in ((summed(mix), whole), (h_parts, h),
                      (tail_parts, tail)):
        assert _rel(got, want) <= TOL
    for got, want in ((summed(mix), ref), (h_parts, jh),
                      (tail_parts, jtail)):
        assert _rel(got, want) <= TOL
    # one decode step from the prefill's state
    cache = {'h': h.clone(), 'conv': tail.clone()}
    w_out, cache = trec.mamba2_decode(p, torch.from_numpy(xt), cache, cfg)
    hs = [o[2][0].clone() for o in mix]
    steps = [trec.ssm_step(parts[r], gathered(torch.from_numpy(xt)), conv,
                           tail_parts, hs[r], cfg, tps[r], torch.float32)
             for r in range(M)]
    j_out, j_cache = jrec.mamba2_decode(
        jl, jnp.asarray(xt), {'h': jh, 'conv': jtail}, jcfg)
    for got, want in ((summed(steps), w_out), (summed(steps), j_out),
                      (torch.cat(hs, 1), j_cache['h']),
                      (torch.cat([o[2] for o in steps], -1),
                       j_cache['conv'])):
        assert _rel(got, want) <= TOL


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
    a = analyze(compiled.as_text())
    out[key + '/flops'] = np.float64(a['flops'])
    for kind, n in a['collectives'].items():
        out[f'{key}/coll/{kind}'] = np.float64(n)


for case, (arch, over, seed, shapes) in SET['cases'].items():
    cfg = get_smoke_config(arch).replace(**over)
    batch = {k: inp[f'{case}/{k}'] for k in ('tokens', 'labels')}
    for shape in shapes:
        # the step donates its params: each step its own
        params = build_model(cfg).init(jax.random.key(seed))
        mesh = mesh_of(tuple(shape))
        key = f'{case}/{shape[0]}x{shape[1]}'
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
cfg = get_smoke_config(SET['arch'])
mesh = mesh_of((1, 4))
b, s = SET['prompt']
with mesh:
    toks = {'tokens': jax.ShapeDtypeStruct((b, s), jnp.int32)}
    fn, _, (p_aval, _) = jsteps.build_prefill_step(cfg, mesh, toks,
                                                   max_len=SET['max_len'])
    collectives('prefill', fn.lower(p_aval, toks).compile())
    fn, _, (avals, _) = jsteps.build_serve_step(cfg, mesh, batch=b,
                                                max_len=SET['max_len'])
    collectives('serve', fn.lower(*avals).compile())
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


def _reference_serve(params, prompt):
    """The reference model's prefill and greedy decode on one device
    (jitted), each token fed back: the tokens, the prefill's cache and
    the last one."""
    model = j_build_model(j_get_smoke_config(ARCH))
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
    """The reference's steps in their own process on 4 forced host
    devices, started first and run while both worlds do; the worlds'
    outputs, the reference's and the inputs."""
    import conftest
    rng = np.random.default_rng(0)
    train, batches = {}, {}
    for i, (case, (arch, over)) in enumerate(CASES.items()):
        cfg = j_get_smoke_config(arch).replace(**over)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batches[case] = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
        train[case] = {'arch': arch, 'over': over, 'batch': batches[case],
                       'params': jax.tree.map(np.asarray, j_build_model(
                           cfg).init(jax.random.key(i)))}
    np.savez(os.path.join(d, 'batch.npz'), **{
        f'{c}/{k}': v for c, bt in batches.items() for k, v in bt.items()})
    prompt = rng.integers(0, j_get_smoke_config(ARCH).vocab_size,
                          (B, 8)).astype(np.int32)
    settings = {'in': os.path.join(d, 'batch.npz'),
                'out': os.path.join(d, 'ref.npz'), 'arch': ARCH, 'lr': LR,
                'cases': {c: (a, o, i, [(1, 4)] + ([(1, 1)] if c == 'ssm'
                                                   else []))
                          for i, (c, (a, o)) in enumerate(CASES.items())},
                'prompt': list(prompt.shape), 'max_len': SERVE['max_len']}
    log = open(os.path.join(d, 'ref.log'), 'w')
    ref_proc = subprocess.Popen(
        [sys.executable, '-c', REF_SCRIPT.replace('SETTINGS',
                                                  repr(settings))],
        env=conftest.forced_device_env(4), stdout=log,
        stderr=subprocess.STDOUT, cwd=ROOT)
    try:
        prefill = {}
        for i, (name, (arch, over, bits)) in enumerate(PREFILL.items()):
            cfg = j_get_smoke_config(arch).replace(**over)
            prefill[name] = {
                'arch': arch, 'over': over, 'bits': bits, 'max_len': 48,
                'params': jax.tree.map(np.asarray, j_build_model(cfg).init(
                    jax.random.key(10 + i))),
                'prompt': rng.integers(0, cfg.vocab_size,
                                       (B, 40)).astype(np.int32)}
        torch.save({'lr': LR, 'train': train, 'prefill': prefill,
                    'serve': {**SERVE, 'prompt': prompt}},
                   os.path.join(d, 'inputs.pt'))
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
                   OMP_NUM_THREADS='1')
        spawned = {n: _spawn_world(n, d, env) for n in (4, 1)}
        out = {n: _join(n, d, *spawned[n]) for n in (4, 1)}
        ref_serve = _reference_serve(train['ssm']['params'],
                                     jnp.asarray(prompt))
        ref_proc.wait(timeout=300)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
        log.close()
    if ref_proc.returncode != 0:
        with open(os.path.join(d, 'ref.log')) as f:
            pytest.fail(f'the reference steps exited {ref_proc.returncode}:'
                        f'\n{f.read()[-4000:]}')
    return {'out': out, 'ref': dict(np.load(settings['out'])),
            'train': train, 'ref_serve': ref_serve}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    return run(str(tmp_path_factory.mktemp('tp_ssm')))


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
        assert (g != b).any(), i
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    for part in ('mu', 'nu'):
        for i, g in enumerate(got[part]):
            want = ref[f'{key}/{part}/{i}']
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale, \
                (part, i)


@pytest.mark.parametrize('case', list(CASES))
def test_train_step_matches_reference(worlds, case):
    before = tree_leaves(worlds['train'][case]['params'])
    for o in worlds['out'][4]:
        got = o['train', case, True]
        assert got['tp']
        _check_step(got, worlds['ref'], f'{case}/1x4', before)


@pytest.mark.parametrize('case', list(CASES))
def test_train_step_matches_the_gather_path(worlds, case):
    """The same step on the 'model' shards against the gather path's:
    loss and grad norm within 1e-5 relative, params within 0.25 x lr (at
    most 0.1% beyond 1e-2 x lr); the Mamba-2 block's leaves and the whole
    table not gathered over 'model' on the shards, the gather path's
    gathered there."""
    for o in worlds['out'][4]:
        a, b = o['train', case, True], o['train', case, False]
        assert abs(a['loss'] - b['loss']) <= 1e-5 * abs(b['loss'])
        assert abs(a['grad_norm'] - b['grad_norm']) <= \
            1e-5 * abs(b['grad_norm'])
        for x, y in zip(a['params'], b['params']):
            d = (x - y).abs()
            assert float(d.max()) <= 0.25 * LR
            assert float((d > 1e-2 * LR).float().mean()) <= 1e-3
        assert a['counts'].get(('gather_tp', 'model'), 0) == 0
        assert a['counts'].get(('gather', 'model'), 0) == 0
        assert a['counts'].get(('all_reduce', 'model'), 0) > 0
        assert b['counts'].get(('gather', 'model'), 0) > 0


def test_per_rank_flops_quarter_on_model_4(worlds):
    """mamba2's (1, 1) step's FLOPs over each (1, 4) rank's: at least 3.6,
    beside the reference's own ratio; the gather path's ranks each
    compute the whole step.  The odd-vocab step computes less a rank on
    the shards than on the gather path (the table's weight gradient
    split over 'model')."""
    ref = worlds['ref']
    ref_ratio = float(ref['ssm/1x1/flops'] / ref['ssm/1x4/flops'])
    whole = worlds['out'][1][0]['train', 'ssm', True]['flops']
    for o in worlds['out'][4]:
        ratio = whole / o['train', 'ssm', True]['flops']
        print(f'mamba2 (1, 1) / (1, 4) FLOPs: port {ratio:.3f}, reference '
              f'{ref_ratio:.3f}')
        assert ratio >= 3.6, (ratio, ref_ratio)
        assert o['train', 'ssm', False]['flops'] == whole
        assert o['train', 'vocab', True]['flops'] < \
            o['train', 'vocab', False]['flops']


def _kinds(counts):
    return {k[0].replace('_', '-') for k, n in counts.items()
            if n and k[1] == 'model' and k[0] in ('all_reduce', 'all_gather')}


def _ref_kinds(ref, key):
    return {k.split('/')[-1] for k in ref if k.startswith(key + '/coll/')}


@pytest.mark.parametrize('step', ('train', 'prefill', 'serve'))
def test_model_axis_collective_kinds_within_reference(worlds, step):
    want = _ref_kinds(worlds['ref'], 'ssm/1x4' if step == 'train' else step)
    assert want
    for o in worlds['out'][4]:
        c = (o['train', 'ssm', True]['counts'] if step == 'train' else
             o['serve', True]['counts'][step == 'serve'])
        assert _kinds(c) and _kinds(c) <= want, (_kinds(c), want)


def _caches_close(got, want, tol):
    jl = jax.tree.leaves(jax.tree.map(np.asarray, want))
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        assert _rel(b.numpy(), a) <= tol


def test_prefill_and_serve_steps_on_model_shards(worlds):
    """mamba2's prefill + 3 serve tokens on (1, 4): tokens equal to the
    gather path's and to the reference's single-device ones, the caches
    within 1e-5 x max of the reference's; the decode state kept on its
    chunks (no leaf gathered over 'model')."""
    toks, first, last = worlds['ref_serve']
    for o in worlds['out'][4]:
        tp, gather = o['serve', True], o['serve', False]
        assert np.array_equal(tp['tokens'].numpy(), toks)
        assert np.array_equal(gather['tokens'].numpy(), toks)
        _caches_close(tp['prefill_cache'], first, TOL)
        _caches_close(tp['cache'], last, TOL)
        for c in tp['counts']:
            assert c.get(('gather_tp', 'model'), 0) == 0
            assert c.get(('gather', 'model'), 0) == 0
        assert tp['prefill_flops'] * 3.6 <= gather['prefill_flops']


@pytest.mark.parametrize('name', list(PREFILL))
def test_chunked_prefill_equals_the_whole_cache_cut(worlds, name):
    """Each rank's chunk of the cache built in place equals, element for
    element, the whole cache built and cut afterwards, on every rank."""
    for o in worlds['out'][4]:
        (ta, ca), (tb, cb) = o['prefill'][name, 'chunk'], \
            o['prefill'][name, 'whole']
        assert torch.equal(ta, tb)
        la, lb = tree_leaves(ca), tree_leaves(cb)
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y)
