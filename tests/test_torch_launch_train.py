"""The port's training runtime and launcher against the JAX package:
``runtime/ft.FaultTolerantLoop`` and ``runtime/elastic.py``, the
checkpoint manager's retention and fallback, the gradient compressor's
error feedback, ``launch/specs.py``, ``launch/mesh.py``'s refusals and
``python -m repro_torch.launch.train``.

Each case of ``tests/test_runtime.py`` runs on the port with that file's
script; where it makes sense the reference runs the same script and the
two agree (the loop's events, restarts and final state exactly; the
checkpoint steps exactly; the compressor within the reference's own
tolerances, 1e-6 and 1e-5 relative).  The one-rank cases run in this
process on a world of one gloo rank, destroyed after the module.  The CLI
runs twice on the smoke config (about 5 s each): with ``--drill`` it must
report ``restarts=1`` and the same final loss as the run without.  About
15 s on one core.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.launch import specs as jspecs
from repro.runtime import FaultTolerantLoop as JLoop
from repro.runtime import SimulatedFailure as JFailure
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.runtime import (FaultTolerantLoop, SimulatedFailure,
                                 elastic_restore, reshard_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------- the FT loop


def _ft_run(Loop, Failure, Manager, tensor, d, inject):
    """tests/test_runtime.py's script: an accumulator stepped 20 times,
    checkpoints every 5, failures injected at steps 7 and 13."""
    fired = set()

    def injector(step):
        if inject and step in (7, 13) and step not in fired:
            fired.add(step)
            raise Failure(f'node lost at {step}')

    loop = Loop(step_fn=lambda s, b: ({'acc': s['acc'] + b}, {}),
                batch_fn=lambda step: tensor(float(step)),
                ckpt=Manager(str(d), keep=3, async_save=False),
                ckpt_every=5, failure_injector=injector)
    state, end = loop.run({'acc': tensor(0.0)}, 0, 20)
    return float(state['acc']), end, loop.restarts, loop.events


@pytest.mark.parametrize('inject', (False, True))
def test_fault_tolerant_loop_recovers(tmp_path, inject):
    """The port's loop on the reference's script: the same final state as
    a failure-free run, the same restarts, events and committed
    checkpoints as the reference's loop."""
    got = _ft_run(FaultTolerantLoop, SimulatedFailure, CheckpointManager,
                  lambda x: torch.tensor(x), tmp_path / 'port', inject)
    want = _ft_run(JLoop, JFailure, JCheckpointManager, jnp.asarray,
                   tmp_path / 'ref', inject)
    clean = _ft_run(FaultTolerantLoop, SimulatedFailure, CheckpointManager,
                    lambda x: torch.tensor(x), tmp_path / 'clean', False)
    assert got[2] == want[2] == (2 if inject else 0)
    assert got[0] == want[0] == clean[0] and got[1] == want[1] == 20
    ev = lambda e: [x if x[0] == 'failure' else (x[0], x[1]) for x in e]  # noqa: E731
    assert ev(got[3]) == ev(want[3])
    assert sorted(os.listdir(tmp_path / 'port')) == \
        sorted(os.listdir(tmp_path / 'ref'))


def test_poison_pill_detection(tmp_path):
    def bad_step(state, batch):
        raise RuntimeError('deterministic bug')

    for Loop, Manager, zeros in (
            (FaultTolerantLoop, CheckpointManager, torch.zeros(())),
            (JLoop, JCheckpointManager, jnp.zeros(()))):
        loop = Loop(step_fn=bad_step, batch_fn=lambda s: None,
                    ckpt=Manager(str(tmp_path / Loop.__module__),
                                 async_save=False),
                    ckpt_every=5, max_restarts=3)
        with pytest.raises(RuntimeError, match='poison pill'):
            loop.run({'x': zeros}, 0, 5)
        assert loop.restarts == 4
        assert [e[0] for e in loop.events] == ['failure'] * 4


# ------------------------------------------ test_runtime.py's other cases


def test_checkpoint_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in range(5):
        mgr.save(s, {'x': torch.full((3,), float(s))})
    mgr.wait()
    steps = sorted(int(d.split('_')[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]
    out, step = mgr.restore_latest({'x': torch.zeros(3)})
    assert step == 4 and float(out['x'][0]) == 4


def test_restore_latest_falls_back_past_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    for s in range(3):
        mgr.save(s, {'x': torch.full((3,), float(s))})
    with open(tmp_path / 'step_00000002' / 'manifest.json', 'r+') as f:
        f.truncate(10)
    out, step = mgr.restore_latest({'x': torch.zeros(3)})
    assert step == 1 and float(out['x'][0]) == 1
    with open(tmp_path / 'step_00000001' / 'proc_0.npz', 'w') as f:
        f.write('not a zip')
    out, step = mgr.restore_latest({'x': torch.zeros(3)})
    assert step == 0 and float(out['x'][0]) == 0
    os.remove(tmp_path / 'step_00000000' / 'manifest.json')
    with pytest.raises(FileNotFoundError, match='all corrupt'):
        mgr.restore_latest({'x': torch.zeros(3)})


def test_grad_compression_error_feedback():
    """tests/test_runtime.py's case on the port, and the reference's
    numbers on the same input."""
    from repro.optim.compression import int8_compress_grads as j_compress
    from repro.optim.compression import int8_decompress as j_decompress
    from repro_torch.optim.compression import (int8_compress_grads,
                                               int8_decompress)
    gn = np.asarray([0.1, -0.2, 0.3001, 1.0], np.float32)
    g = {'w': torch.from_numpy(gn)}
    q, s, r = int8_compress_grads(g, None)
    deq = int8_decompress(q, s)
    np.testing.assert_allclose((deq['w'] + r['w']).numpy(), gn, rtol=1e-6)
    q2, s2, r2 = int8_compress_grads(g, r)
    total = (int8_decompress(q2, s2)['w'] + r2['w']).numpy()
    np.testing.assert_allclose(total, 2 * gn - deq['w'].numpy(), rtol=1e-5)
    jq, js, jr = j_compress({'w': jnp.asarray(gn)}, None)
    jq2, js2, jr2 = j_compress({'w': jnp.asarray(gn)}, jr)
    np.testing.assert_allclose(total, np.asarray(
        j_decompress(jq2, js2)['w'] + jr2['w']), rtol=1e-6)


@pytest.fixture(scope='module')
def one_rank():
    """A world of one gloo rank in this process, and its 1 x 1 CPU mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    started = init_distributed('cpu')
    yield make_local_mesh('cpu')
    if started:
        dist.destroy_process_group()


def test_elastic_reshard_roundtrip(one_rank, tmp_path):
    """tests/test_runtime.py's case: a tree placed on a 1-rank mesh keeps
    its values and takes the sharding; then a checkpoint of it restores
    through ``elastic_restore`` onto the mesh bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.sharding import NamedSharding, P
    tree = {'w': torch.arange(16.0).reshape(4, 4)}
    sh = {'w': NamedSharding(one_rank, P(None, 'model'))}
    out = reshard_tree(tree, sh)
    assert isinstance(out['w'], DTensor)
    assert torch.equal(out['w'].full_tensor(), tree['w'])
    assert tuple(out['w'].placements) == sh['w'].placements
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, out)
    back, step = elastic_restore(mgr, out, one_rank,
                                 lambda path, leaf: P(None, 'model'))
    assert step == 3 and torch.equal(back['w'].full_tensor(), tree['w'])


# -------------------------------------------------------------- the mesh


def test_production_mesh_refuses_the_wrong_world():
    from repro_torch.launch.mesh import (AbstractMesh, data_axes,
                                         make_production_mesh)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f'needs {n} ranks; the world '
                                             f'has 1'):
            make_production_mesh(multi_pod=multi_pod, device='cpu')
    assert data_axes(AbstractMesh((2, 16, 16), ('pod', 'data', 'model'))) \
        == ('pod', 'data')


def test_input_specs_match_reference():
    assert specs.cells(ARCH_NAMES) == jspecs.cells(ARCH_NAMES)
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.LONG_CTX_ARCHS == jspecs.LONG_CTX_ARCHS
    for arch in ARCH_NAMES:
        for shape in specs.SHAPES:
            got = specs.input_specs(get_config(arch), shape)
            want = jspecs.input_specs(j_get_config(arch), shape)
            if specs.SHAPES[shape]['kind'] == 'decode':
                assert got == want
                continue
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].device.type == 'meta'
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).split('.')[-1] == \
                    str(want[k].dtype)


# --------------------------------------------------------------- the CLI


def _train_cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    return subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.train', '--smoke',
         '--device', 'cpu', '--steps', '6', '--ckpt-every', '2', *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_train_cli_drill_restarts_once_and_matches(tmp_path):
    runs = {}
    for drill in (False, True):
        ckpt = str(tmp_path / f'ckpt_{drill}')
        r = _train_cli(tmp_path, '--ckpt', ckpt,
                       *(('--drill',) if drill else ()))
        assert r.returncode == 0, r.stderr[-4000:]
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith('finished at step')]
        assert len(line) == 1, r.stdout
        runs[drill] = line[0]
        assert sorted(os.listdir(ckpt)) == ['step_00000002', 'step_00000004',
                                            'step_00000005']
    assert runs[False].startswith('finished at step 6; restarts=0; loss ')
    assert runs[True].startswith('finished at step 6; restarts=1; loss ')
    assert runs[True].split('loss ')[1] == runs[False].split('loss ')[1]
