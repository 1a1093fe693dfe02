"""The port's mesh code (``launch/sharding.py``, ``launch/steps.py``,
``launch/serving.py``, ``runtime/elastic.py``,
``optim/compression.allreduce_compressed``) against the JAX package.

* Spec parity: every arch at its published config (abstract params on
  both sides: ``jax.eval_shape`` and the ``meta`` device), on (16, 16),
  (2, 16, 16) and (2, 4) meshes (the reference's rules on a
  ``jax.sharding.AbstractMesh``, the port's on its ``AbstractMesh``):
  every param leaf's spec with FSDP on and off, every cache leaf's at the
  decode_32k shape with long_ctx on and off, ``batch_spec`` and the ZeRO-1
  moments.  Exact.
* On gloo ranks (``tests/torch_mesh_jobs.py``; worlds of 4, 2 and 1 ranks,
  each spawned once for the module, every group started from a
  ``file://`` init method under the module's temporary directory with a
  60 s collective timeout, every world joined within 150 s):
  - one ``build_train_step`` step of the tinyllama smoke config (fp32) on
    (2, 2) and on one rank, against the reference's ``build_train_step``
    on a 1 x 1 mesh on the same params and numpy batch: the loss and the
    grad norm within 1e-5 relative, the moments within 1e-5 x their
    max (the matmuls and the DP mean sum in other orders), the params no
    element more than 0.25 x lr apart and at most 0.1% of elements more
    than 1e-2 x lr apart (AdamW's first step is ``g / (|g| + eps)``
    times lr: a gradient within float noise of 0 moves its element by up
    to lr either way, as ``tests/test_torch_train.py`` holds the Q step),
    and each rank's local shard shapes equal to those of the reference's
    specs (ZeRO-1 moments included);
  - ``allreduce_compressed`` over two rounds against the reference's under
    a jitted ``shard_map`` on 4 forced host devices: bit for bit, on 16
    leaves of magnitudes 1e-6 to 1e3 (under jit XLA folds the scale's
    ``/ 127`` into ``* fp32(1/127)`` and fuses the residual's ``g - q *
    s``, so the port compresses with that arithmetic, ``jitted=True``,
    itself held against ``jax.jit`` of ``int8_compress_grads`` here);
  - ``build_prefill_step`` and 3 greedy steps of ``build_serve_step``
    (fp32 and int8 caches; long_ctx at batch 1) on (2, 2) and on one rank:
    the reference model's jitted single-device tokens, exactly;
  - ``make_decode_ctx`` at 2 and 4 ranks, long_ctx both ways, GQA with an
    fp32 and an int8 cache and MLA: the outputs within 1e-5 x max|out| of
    ``jax.jit`` of the reference's single-device ``decode_attn_reference``
    / ``decode_mla_reference`` (the merge sums in another order), the new
    caches equal to the reference's bit for bit, and each rank's cache
    chunk its 1/n of the sequence;
  - ``elastic_restore`` of a (2, 2)-placed checkpoint onto (1, 2) and one
    rank: the full values bit-equal, the chunks those of the new mesh.

The reference's ``make_local_mesh`` makes Explicit axes under jax 0.9, on
which its own activation policy's ``with_sharding_constraint`` raises;
its train step runs here on the same 1 x 1 mesh with Auto axes.  About
40 s on one core.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import AxisType, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models.model import build_model as j_build_model
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, 'tests', 'torch_mesh_jobs.py')
MESHES = (((16, 16), ('data', 'model')),
          ((2, 16, 16), ('pod', 'data', 'model')),
          ((2, 4), ('data', 'model')))
ARCH = 'tinyllama-1.1b'
LR = 1e-3
B, S = 4, 16
WORLD_TIMEOUT_S = 150


# ------------------------------------------------------------- spec parity


def _j_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, (JP, JNamedSharding)))]


def _specs(sh_tree):
    return [tuple(s.spec) if hasattr(s, 'spec') else tuple(s)
            for s in tree_leaves(sh_tree)]


@pytest.mark.parametrize('arch', ARCH_NAMES)
def test_sharding_rules_match_reference(arch):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jp = jsteps.abstract_params(j_build_model(jcfg))
    model = build_model(cfg)
    tp = model.init(torch.Generator(), 'meta')
    jc = jax.eval_shape(lambda: j_build_model(jcfg).init_cache(128, 32768))
    tc = model.init_cache(128, 32768, 'meta')
    jo = jax.eval_shape(j_adamw(LR).init, jp)
    to = adamw(LR).init(tp)
    assert [tuple(x.shape) for x in tree_leaves(tp)] == \
        [x.shape for x in jax.tree.leaves(jp)]
    for shape, axes in MESHES:
        jm, tm = JAbstractMesh(shape, axes), AbstractMesh(shape, axes)
        for fsdp in (True, False):
            jps = jsh.params_shardings(jp, jcfg, jm, fsdp=fsdp)
            tps = tsh.params_shardings(tp, cfg, tm, fsdp=fsdp)
            assert _specs(tps) == [tuple(s.spec)
                                   for s in jax.tree.leaves(jps)]
            jz = jsh.zero1_shardings(jo, jps, jm)
            tz = tsh.zero1_shardings(to, tps, tm)
            for part in ('step', 'mu', 'nu'):
                assert _specs(getattr(tz, part)) == [
                    tuple(s.spec) for s in
                    jax.tree.leaves(getattr(jz, part))], (part, fsdp)
        for long_ctx in (False, True):
            want = jax.tree_util.tree_map_with_path(
                lambda p, x: jsh.cache_spec(p, x, jcfg, jm,
                                            long_ctx=long_ctx), jc)
            got = tree_map_with_path(
                lambda p, x: tsh.cache_spec(p, x, cfg, tm,
                                            long_ctx=long_ctx), tc)
            assert _specs(got) == _j_specs(want)
        for bshape in ((256, 4096), (32,), (1, 8), (6,)):
            assert tuple(tsh.batch_spec(bshape, tm)) == \
                tuple(jsh.batch_spec(bshape, jm))


def test_placements_split_major_to_minor():
    """An axis tuple on one dim becomes Shard(d) on each of its mesh dims
    (DTensor splits major to minor in mesh order, as JAX does); an axis
    tuple out of mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    m = AbstractMesh((2, 4, 8), ('pod', 'data', 'model'))
    spec = tsh.P(('pod', 'data'), 'model', None)
    assert tsh.placements(spec, m) == (Shard(0), Shard(0), Shard(1))
    assert tsh.placements(tsh.P(None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match='mesh order'):
        tsh.placements(tsh.P(('data', 'pod')), m)


# -------------------------------------------------------------- gloo ranks


def _reference_train(params, batch):
    jcfg = j_get_smoke_config(ARCH)
    mesh = jax.make_mesh((1, 1), ('data', 'model'),
                         axis_types=(AxisType.Auto,) * 2)
    with mesh:
        fn, _, (p_aval, _, p_sh, o_sh) = jsteps.build_train_step(
            jcfg, mesh, jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch),
            lr=LR)
        p, o, m = fn(jax.tree.map(jnp.asarray, params),
                     j_adamw(LR).init(params), batch)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'params': [np.asarray(x) for x in jax.tree.leaves(p)],
            'mu': [np.asarray(x) for x in jax.tree.leaves(o.mu)],
            'nu': [np.asarray(x) for x in jax.tree.leaves(o.nu)],
            'before': [np.asarray(x) for x in jax.tree.leaves(params)],
            'local_params': _j_local_shapes(p_aval, (2, 2)),
            'local_mu': _j_local_shapes(p_aval, (2, 2), zero1=True)}


def _j_local_shapes(p_aval, shape, zero1=False):
    """Each param leaf's (ZeRO-1 moment's) chunk on a ('data', 'model')
    mesh of ``shape`` under the reference's specs."""
    jcfg = j_get_smoke_config(ARCH)
    mesh = JAbstractMesh(shape, ('data', 'model'))
    shs = jsh.params_shardings(p_aval, jcfg, mesh)
    if zero1:
        shs = jsh.zero1_shardings(jax.eval_shape(j_adamw(LR).init, p_aval),
                                  shs, mesh).mu

    def local(shape, spec):
        return tuple(n // int(np.prod([mesh.shape[a] for a in (
            () if s is None else (s if isinstance(s, tuple) else (s,)))]))
            for n, s in zip(shape, tuple(spec) + (None,) * len(shape)))
    return [local(x.shape, s.spec) for x, s in zip(jax.tree.leaves(p_aval),
                                                    jax.tree.leaves(shs))]


def _decode_cases(rng):
    """GQA over an fp32 and an int8 cache (tinyllama smoke, a window on
    the int8 one) and MLA (deepseek smoke): a cache of 16 slots, 11
    filled, the new token at position 11 (slot 11: the third of four
    chunks, the second of two)."""
    cases = {}
    for name, arch, bits, window in (('gqa-kv0', ARCH, 0, 0),
                                     ('gqa-kv8', ARCH, 8, 6),
                                     ('mla', 'deepseek-v3-671b', 0, 0)):
        cfg = j_get_smoke_config(arch).replace(kv_cache_bits=bits)
        Sc, cur, filled = 16, 11, 11
        pos = np.full((Sc,), -1, np.int32)
        pos[:filled] = np.arange(filled)
        meta = {'slots': np.arange(Sc, dtype=np.int32), 'pos': pos,
                'total': np.asarray(Sc, np.int32)}
        f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
        if cfg.use_mla:
            r, dr, H = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.num_heads
            cache = {'ckv': f32(B, Sc, r), 'kr': f32(B, Sc, dr),
                     'meta': meta}
            args = [f32(B, H, r), f32(B, H, dr), f32(B, r), f32(B, dr)]
            kw = {}
        else:
            K, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
            if bits:
                cache = {'k': rng.integers(-127, 128, (B, Sc, K, hd),
                                           dtype=np.int8),
                         'v': rng.integers(-127, 128, (B, Sc, K, hd),
                                           dtype=np.int8),
                         'k_s': np.abs(f32(B, Sc, K)) / 127,
                         'v_s': np.abs(f32(B, Sc, K)) / 127, 'meta': meta}
            else:
                cache = {'k': f32(B, Sc, K, hd), 'v': f32(B, Sc, K, hd),
                         'meta': meta}
            args = [f32(B, H, hd), f32(B, K, hd), f32(B, K, hd)]
            kw = {'window': window, 'attn_softcap': 0.0}
        cases[name] = {'arch': arch, 'cache': cache, 'args': args,
                       'cur': cur, 'kw': kw}
    return cases


def _reference_decode(case):
    jc = jax.tree.map(jnp.asarray, case['cache'])
    args = [jnp.asarray(a) for a in case['args']]
    if 'ckv' in jc:
        fn = jax.jit(lambda *a: jattn.decode_mla_reference(*a))
    else:
        fn = jax.jit(lambda q, nk, nv, c, cur: jattn.decode_attn_reference(
            q, nk, nv, c, cur, **case['kw']))
    out, cache = fn(*args, jc, jnp.asarray(case['cur'], jnp.int32))
    return np.asarray(out), jax.tree.map(np.asarray, cache)


COMPRESS_SCRIPT = r'''
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.optim.compression import allreduce_compressed
g = dict(np.load(IN_PATH))
mesh = jax.make_mesh((2, 2), ('data', 'model'))
ax = ('data', 'model')

def body(g, r):
    g = jax.tree.map(lambda x: x[0], g)
    r = None if r is None else jax.tree.map(lambda x: x[0], r)
    mean, res = allreduce_compressed(g, r, ax)
    return (jax.tree.map(lambda x: x[None], mean),
            jax.tree.map(lambda x: x[None], res))

spec = P(ax)
f1 = jax.jit(jax.shard_map(lambda g: body(g, None), mesh=mesh,
                           in_specs=(spec,), out_specs=(spec, spec),
                           check_vma=False))
f2 = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                           out_specs=(spec, spec), check_vma=False))
m1, r1 = f1(g)
m2, r2 = f2(g, r1)
out = {}
for i, (m, r) in enumerate(((m1, r1), (m2, r2))):
    for k in g:
        out[f'mean{i}_{k}'] = np.asarray(m[k])
        out[f'res{i}_{k}'] = np.asarray(r[k])
np.savez(OUT_PATH, **out)
'''


def _run_world(n, d):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    logs = [open(os.path.join(d, f'log_{n}_{r}.txt'), 'w')
            for r in range(n)]
    procs = [subprocess.Popen([sys.executable, JOBS, d, str(r), str(n)],
                              env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(n)]
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


@pytest.fixture(scope='module')
def worlds(tmp_path_factory, forced_devices):
    d = str(tmp_path_factory.mktemp('mesh'))
    rng = np.random.default_rng(0)
    jcfg = j_get_smoke_config(ARCH)
    params = jax.tree.map(np.asarray,
                          j_build_model(jcfg).init(jax.random.key(0)))
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
    # leaves of many magnitudes: the jitted scale rule (max|g| x
    # fp32(1/127)) and the fused residual both show in the codes
    grads = {f'g{i}': (rng.standard_normal((4, 33, 7 + i))
                       * 10.0 ** rng.uniform(-6, 3)).astype(np.float32)
             for i in range(16)}
    cases = _decode_cases(rng)
    serve = {name: {'bits': bits, 'long_ctx': long_ctx, 'max_len': 16,
                    'steps': 3, 'prompt': rng.integers(
                        0, jcfg.vocab_size, (b, 8)).astype(np.int32)}
             for name, bits, long_ctx, b in (('kv0', 0, False, B),
                                             ('kv8', 8, False, B),
                                             ('long-ctx', 0, True, 1))}
    torch.save({'arch': ARCH, 'lr': LR, 'params': params, 'batch': batch,
                'grads': grads, 'decode': cases, 'serve': serve},
               os.path.join(d, 'inputs.pt'))
    out = {n: _run_world(n, d) for n in (4, 2, 1)}
    np.savez(os.path.join(d, 'grads.npz'), **grads)
    forced_devices(COMPRESS_SCRIPT.replace(
        'IN_PATH', repr(os.path.join(d, 'grads.npz'))).replace(
        'OUT_PATH', repr(os.path.join(d, 'ref_compress.npz'))), n=4,
        timeout=300)
    ref_compress = dict(np.load(os.path.join(d, 'ref_compress.npz')))
    return {'out': out, 'params': params, 'batch': batch, 'cases': cases,
            'ref_train': _reference_train(params, batch),
            'ref_compress': ref_compress,
            'ref_decode': {k: _reference_decode(c) for k, c in cases.items()},
            'serve': serve,
            'ref_serve': {k: _reference_serve(params, c)
                          for k, c in serve.items()}}


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


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize('world', (4, 1))
def test_train_step_matches_reference(worlds, world):
    ref = worlds['ref_train']
    outs = [o['train'] for o in worlds['out'][world]]
    for o in outs:                       # every rank: the same numbers
        assert _rel(o['loss'], ref['loss']) <= 1e-5
        assert _rel(o['grad_norm'], ref['grad_norm']) <= 1e-5
        assert o['step'] == 1
    o = outs[0]
    for got, want, before in zip(o['params'], ref['params'],
                                 ref['before']):
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        d = np.abs(got - want)
        assert float(d.max()) <= 0.25 * LR
        assert float((d > 1e-2 * LR).mean()) <= 1e-3
        assert (got != before).any()
    for part in ('mu', 'nu'):
        for got, want in zip(o[part], ref[part]):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    if world == 4:
        for o in outs:
            assert o['local_params'] == ref['local_params']
            assert o['local_mu'] == ref['local_mu']
    else:
        assert o['local_params'] == [w.shape for w in ref['params']]


@pytest.mark.parametrize('world', (4, 1))
@pytest.mark.parametrize('case', ('kv0', 'kv8', 'long-ctx'))
def test_prefill_and_serve_steps_match_reference(worlds, world, case):
    """``build_prefill_step`` + 3 steps of ``build_serve_step`` (each
    token fed back) give the reference model's greedy tokens on one
    device; on (2, 2) each rank holds its batch chunk (none with
    long_ctx, at batch 1) and its 1/2 (long_ctx: 1/4) of the cache."""
    want = worlds['ref_serve'][case]
    c = worlds['serve'][case]
    b = c['prompt'].shape[0]
    for o in worlds['out'][world]:
        got = o['serve'][case]
        assert np.array_equal(got['tokens'].numpy(), want)
        n = {4: 4 if c['long_ctx'] else 2, 1: 1}[world]
        b_local = b if c['long_ctx'] or world == 1 else b // 2
        assert got['k_local'][1:3] == (b_local, c['max_len'] // n)


def test_allreduce_compressed_bit_for_bit(worlds):
    ref = worlds['ref_compress']
    for rank, o in enumerate(worlds['out'][4]):
        o = o['compress']
        for i in range(2):
            for k in o['mean'][i]:
                for got, name in ((o['mean'][i][k], 'mean'),
                                  (o['residual'][i][k], 'res')):
                    want = ref[f'{name}{i}_{k}'][rank]
                    assert got.dtype == torch.float32
                    assert np.array_equal(got.numpy().view(np.uint32),
                                          want.view(np.uint32)), \
                        (rank, i, k, name)


@pytest.mark.parametrize('world', (4, 2))
@pytest.mark.parametrize('case', ('gqa-kv0', 'gqa-kv8', 'mla'))
def test_decode_ctx_matches_single_device(worlds, world, case):
    want_out, want_cache = worlds['ref_decode'][case]
    n_local = {4: {False: 8, True: 4}, 2: {False: 8, True: 8}}[world]
    b_local = {4: {False: B // 2, True: B}, 2: {False: B, True: B}}[world]
    for long_ctx in (False, True):
        for rank, o in enumerate(worlds['out'][world]):
            got = o['decode'][(case, long_ctx)]
            out = got['out'].numpy()
            scale = float(np.abs(want_out).max())
            assert float(np.abs(out - want_out).max()) <= 1e-5 * scale
            flat_got = tree_leaves(got['cache'])
            flat_want = jax.tree.leaves(want_cache)
            assert len(flat_got) == len(flat_want)
            for g, w in zip(flat_got, flat_want):
                assert np.array_equal(g.numpy(), w), (case, long_ctx)
            local = got['local']
            key = 'ckv' if 'ckv' in local else 'k'
            assert local[key][:2] == (b_local[long_ctx], n_local[long_ctx])
            assert local['meta']['slots'] == (n_local[long_ctx],)


@pytest.mark.parametrize('world', (2, 1))
def test_elastic_restore_onto_smaller_meshes(worlds, world):
    """A checkpoint of the (2, 2)-placed params restores onto (1, 2) and
    one rank: the full values bit for bit, each rank's chunk that of the
    new mesh."""
    want = jax.tree.leaves(worlds['params'])
    p_aval = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          worlds['params'])
    saved = worlds['out'][4][0]['saved_local']
    assert saved == _j_local_shapes(p_aval, (2, 2))
    assert saved != [w.shape for w in want]      # the save was sharded
    for o in worlds['out'][world]:
        r = o['restore']
        assert r['step'] == 7
        for got, w in zip(r['full'], want):
            assert np.array_equal(got.numpy(), w)
        assert r['local'] == _j_local_shapes(
            p_aval, {2: (1, 2), 1: (1, 1)}[world])


def test_int8_compress_grads_jitted_rule():
    """``int8_compress_grads(jitted=True)`` against ``jax.jit`` of the
    reference's over 3 rounds, bit for bit; the eager rule differs from it
    on some of these leaves."""
    from repro.optim.compression import int8_compress_grads as j_compress
    from repro_torch.optim import int8_compress_grads
    rng = np.random.default_rng(3)
    g = {f'g{i}': (rng.standard_normal((40,)) * 10.0 ** rng.uniform(-6, 3))
         .astype(np.float32) for i in range(64)}
    jfn = jax.jit(j_compress)
    jr = tr = None
    differs = 0
    for _ in range(3):
        jq, js, jr = jfn(g, jr)
        tq, ts, tr = int8_compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, tr, jitted=True)
        _, es, _ = int8_compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, None)
        for k in g:
            assert np.array_equal(tq[k].numpy(), np.asarray(jq[k]))
            for a, b in ((ts[k], js[k]), (tr[k], jr[k])):
                assert np.array_equal(np.atleast_1d(a.numpy()).view(np.uint32),
                                      np.atleast_1d(np.asarray(b))
                                      .view(np.uint32))
            differs += int(es[k] != ts[k])
    assert differs
