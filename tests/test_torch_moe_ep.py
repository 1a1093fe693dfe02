"""The MoE block's expert-parallel path in the port (``models/moe.py``
``_moe_block_ep``, ``_dispatch_local``; the expert shards of
``models/actsharding.py``) against the JAX package, on gloo ranks
(``tests/torch_moe_ep_jobs.py``; a world of 8 ranks on a (2, 4) mesh and
one of 4 on (2, 2), each spawned once for the module, every group started
from a ``file://`` init method under the module's temporary directory with
a 60 s collective timeout, every world joined within 150 s):

* the reference's five cases of ``tests/test_moe_ep.py`` (E = 4, 2, 8 and
  3 on the mixtral smoke config, the deepseek-style shared expert at E =
  8), and two more whose FFN dim (1024) the rules shard over 'data' too
  (FSDP), one a2a and one f-TP: each rank runs ``moe_block`` under the
  mesh policy on its batch chunk, its params on the sharding rules' specs;
  the output within 1e-5 of the reference's ``_moe_block_dense`` on the
  whole batch, and the gradients of ``sum(out * ct)`` (x's, the router's,
  every expert leaf's, the shared expert's) within 1e-5 x max of
  ``jax.grad`` of the reference's (the leaves' gradients are the DP mean,
  so the port's are taken x 2).  Each case asserts which mode ran, by the
  collectives it called; under ``REPRO_MOE_MODE=dense`` none runs and the
  gathered dense block gives the same numbers;
* one ``build_train_step`` step of the mixtral and deepseek smoke configs
  on (2, 2) against the reference's jitted train step on a (2, 2) mesh of
  4 forced host devices (its own expert-parallel path under
  ``shard_map``): loss and grad norm within 1e-4 relative, the AdamW
  moments within 1e-4 x their max, the params no element more than 0.25
  x lr apart and at most 0.1% of all elements more than 1e-2 x lr apart
  (AdamW's first step, ROADMAP C), each of those with a first moment
  within 1e-5 x its leaf's max of 0 (float noise, which the first step
  turns into up to lr either way; a leaf of 512 elements has one).  A
  backward that summed where it should slice would put the moments off by
  a factor of the 'model' size.

About 70 s: the reference's train steps (a subprocess on 4 forced host
devices) run beside the reference's block cases (about 20 s) and the two
worlds (about 15 s).
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
from repro.models.model import build_model as j_build_model
from repro.models.moe import _moe_block_dense as j_moe_dense
from repro.models.moe import init_moe as j_init_moe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, 'tests', 'torch_moe_ep_jobs.py')
WORLD_TIMEOUT_S = 150
LR = 1e-3
TRAIN_ARCHS = ('mixtral-8x7b', 'deepseek-v3-671b')

#: name -> (arch, config overrides, seed, mode); the first five are the
#: reference's cases (tests/test_moe_ep.py)
CASES = {
    'E4': ('mixtral-8x7b', dict(n_experts=4, top_k=2, moe_d_ff=64,
                                capacity_factor=8.0), 0, 'a2a'),
    'E2': ('mixtral-8x7b', dict(n_experts=2, top_k=2, moe_d_ff=64,
                                capacity_factor=8.0), 1, 'ftp'),
    'E8': ('mixtral-8x7b', dict(n_experts=8, top_k=2, moe_d_ff=64,
                                capacity_factor=8.0), 2, 'a2a'),
    'E3': ('mixtral-8x7b', dict(n_experts=3, top_k=2, moe_d_ff=64,
                                capacity_factor=8.0), 3, 'ftp'),
    'deepseek': ('deepseek-v3-671b', dict(n_experts=8, top_k=2, moe_d_ff=64,
                                          n_shared_experts=1,
                                          capacity_factor=16.0), 5, 'a2a'),
    'fsdp-a2a': ('mixtral-8x7b', dict(n_experts=8, top_k=2, moe_d_ff=1024,
                                      capacity_factor=8.0), 7, 'a2a'),
    'fsdp-ftp': ('mixtral-8x7b', dict(n_experts=2, top_k=2, moe_d_ff=1024,
                                      capacity_factor=8.0), 8, 'ftp'),
}

TRAIN_SCRIPT = r'''
import numpy as np, jax
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch import steps as jsteps
from repro.models.model import build_model
from repro.optim import adamw
inp = np.load(IN_PATH)
out = {}
mesh = jax.make_mesh((2, 2), ('data', 'model'),
                     axis_types=(AxisType.Auto,) * 2)
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    params = build_model(cfg).init(jax.random.key(0))
    batch = {'tokens': inp[arch + '/tokens'], 'labels': inp[arch + '/labels']}
    with mesh:
        fn, _, _ = jsteps.build_train_step(
            cfg, mesh, jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch),
            lr=LR)
        p, o, m = fn(params, adamw(LR).init(params), batch)
    out[arch + '/loss'] = np.float64(m['loss'])
    out[arch + '/grad_norm'] = np.float64(m['grad_norm'])
    for part, tree in (('params', p), ('mu', o.mu), ('nu', o.nu)):
        for i, x in enumerate(jax.tree.leaves(tree)):
            out[f'{arch}/{part}/{i}'] = np.asarray(x)
np.savez(OUT_PATH, **out)
'''


def _run_world(n, d):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1', REPRO_MOE_MODE='auto')
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


def _block_case(name):
    """The reference's params, x and a cotangent for one case, as numpy;
    its dense output and gradients."""
    arch, over, seed, _ = CASES[name]
    cfg = j_get_smoke_config(arch).replace(**over)
    p = j_init_moe(jax.random.key(seed), cfg)
    x = jax.random.normal(jax.random.key(seed + 10),
                          (4, 16, cfg.d_model)) * 0.3
    ct = np.random.default_rng(seed).standard_normal(
        x.shape).astype(np.float32)
    ref = j_moe_dense(p, x, cfg)

    def loss(p, x):
        return jnp.sum(j_moe_dense(p, x, cfg) * ct)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    flat = jax.tree_util.tree_flatten_with_path(gp)[0]
    grads = {'/'.join(str(getattr(k, 'key', k)) for k in path):
             np.asarray(g) for path, g in flat}
    return ({'arch': arch, 'cfg': over,
             'params': jax.tree.map(np.asarray, p), 'x': np.asarray(x),
             'ct': ct},
            {'y': np.asarray(ref), 'x_grad': np.asarray(gx),
             'grads': grads})


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """The reference's train steps start first, in their own process, and
    run while the reference's block cases and the port's worlds do."""
    import conftest
    d = str(tmp_path_factory.mktemp('moe_ep'))
    rng = np.random.default_rng(0)
    train, batches = {}, {}
    for arch in TRAIN_ARCHS:
        cfg = j_get_smoke_config(arch)
        toks = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
        batch = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
        batches[arch + '/tokens'] = batch['tokens']
        batches[arch + '/labels'] = batch['labels']
        train[arch] = {'batch': batch}
    np.savez(os.path.join(d, 'batches.npz'), **batches)
    script = TRAIN_SCRIPT.replace(
        'IN_PATH', repr(os.path.join(d, 'batches.npz'))).replace(
        'OUT_PATH', repr(os.path.join(d, 'ref_train.npz'))).replace(
        'ARCHS', repr(TRAIN_ARCHS)).replace('LR', repr(LR))
    ref_log = open(os.path.join(d, 'ref_train.log'), 'w')
    ref_proc = subprocess.Popen([sys.executable, '-c', script],
                                env=conftest.forced_device_env(4),
                                stdout=ref_log, stderr=subprocess.STDOUT,
                                cwd=ROOT)
    try:
        block, ref_block = {}, {}
        for name in CASES:
            block[name], ref_block[name] = _block_case(name)
        for arch in TRAIN_ARCHS:
            cfg = j_get_smoke_config(arch)
            train[arch]['params'] = jax.tree.map(
                np.asarray, j_build_model(cfg).init(jax.random.key(0)))
        torch.save({'block': block, 'train': train, 'lr': LR},
                   os.path.join(d, 'inputs.pt'))
        out = {n: _run_world(n, d) for n in (8, 4)}
        ref_proc.wait(timeout=300)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
        ref_log.close()
    if ref_proc.returncode != 0:
        with open(os.path.join(d, 'ref_train.log')) as f:
            pytest.fail(f'reference train steps exited '
                        f'{ref_proc.returncode}:\n{f.read()[-4000:]}')
    ref_train = dict(np.load(os.path.join(d, 'ref_train.npz')))
    return {'out': out, 'ref_block': ref_block, 'train': train,
            'ref_train': ref_train}


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - want).max()) <= tol * scale


@pytest.mark.parametrize('name', list(CASES))
def test_expert_parallel_block_matches_reference_dense(worlds, name):
    """Output to 1e-5 (the reference's own bound), gradients to 1e-5 x
    max, the mode by its collectives, the expert leaves on their stored
    chunks (E/4 experts a rank where 'model' divides E)."""
    ref = worlds['ref_block'][name]
    arch, over, _, mode = CASES[name]
    E = over['n_experts']
    n_dp = 2
    for o in worlds['out'][8]:
        got = o['block'][(name, 'auto')]
        dp = got['dp']
        lo, hi = 2 * dp, 2 * dp + 2
        err = float(np.abs(got['y'].numpy() - ref['y'][lo:hi]).max())
        assert err <= 1e-5, (name, err)
        assert _close(got['x_grad'].numpy(), ref['x_grad'][lo:hi], 1e-5)
        assert set(got['grads']) == set(ref['grads'])
        for path, g in got['grads'].items():
            assert _close(n_dp * g.numpy(), ref['grads'][path], 1e-5), \
                (name, path)
        calls = got['calls']
        if mode == 'a2a':
            assert calls.get('_AllToAll') == 2 and '_Sum' not in calls
            assert calls.get('_SeqSlice') == 1
            assert calls.get('_SeqGather') == 1
        else:
            assert calls.get('_Sum') == 1 and '_AllToAll' not in calls
        assert got['local']['wi'][0] == (E // 4 if E % 4 == 0 else E)
        if over['moe_d_ff'] == 1024:         # FSDP: f over 'data' too
            assert got['local']['wi'][2] < over['moe_d_ff']


@pytest.mark.parametrize('name', ('E4', 'E3', 'deepseek'))
def test_dense_mode_takes_the_gathered_path(worlds, name):
    """``REPRO_MOE_MODE=dense``: no expert-parallel collective runs, the
    leaves are gathered whole and the dense block on the rank's chunk
    gives the reference's numbers (no capacity binds in these cases)."""
    ref = worlds['ref_block'][name]
    for o in worlds['out'][8]:
        got = o['block'][(name, 'dense')]
        assert got['calls'] == {}
        lo = 2 * got['dp']
        assert float(np.abs(got['y'].numpy()
                            - ref['y'][lo:lo + 2]).max()) <= 1e-5
        for path, g in got['grads'].items():
            assert _close(2 * g.numpy(), ref['grads'][path], 1e-5), path


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize('arch', TRAIN_ARCHS)
def test_moe_train_step_matches_reference_on_2x2(worlds, arch):
    ref = worlds['ref_train']
    before = [np.asarray(x) for x in
              jax.tree.leaves(worlds['train'][arch]['params'])]
    for o in worlds['out'][4]:
        got = o['train'][arch]
        assert _rel(got['loss'], float(ref[f'{arch}/loss'])) <= 1e-4
        assert _rel(got['grad_norm'],
                    float(ref[f'{arch}/grad_norm'])) <= 1e-4
    got = worlds['out'][4][0]['train'][arch]
    assert len(got['params']) == len(before)
    n_far = n_all = 0
    for i, (g, b) in enumerate(zip(got['params'], before)):
        want = ref[f'{arch}/params/{i}']
        g = g.numpy()
        assert g.shape == want.shape and g.dtype == want.dtype
        d = np.abs(g - want)
        assert float(d.max()) <= 0.25 * LR, i
        far = d > 1e-2 * LR
        # AdamW's first step moves an element whose gradient is float
        # noise by up to lr either way: every such element's first moment
        # is within 1e-5 x the leaf's max of 0
        mu = ref[f'{arch}/mu/{i}']
        assert (np.abs(mu[far]) <= 1e-5 * np.abs(mu).max()).all(), i
        n_far += int(far.sum())
        n_all += far.size
        assert (g != b).any(), i
    assert n_far <= 1e-3 * n_all, (n_far, n_all)
    for part in ('mu', 'nu'):
        for i, g in enumerate(got[part]):
            assert _close(g.numpy(), ref[f'{arch}/{part}/{i}'], 1e-4), \
                (part, i)

