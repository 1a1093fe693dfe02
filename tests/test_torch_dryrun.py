"""The port's dry-run (``launch/dryrun.py``, ``launch/op_analysis.py``)
against the JAX package's compiled steps, on the CPU.

Reference side: its ``build_train_step``, ``build_prefill_step`` and
``build_serve_step`` at the smoke configs of tinyllama-1.1b, gemma2-9b and
whisper-small (batch 8, sequence 32) on (1, 4) and (2, 2) meshes of forced
host devices, and the train step on (1, 1); deepseek-v3-671b's and
recurrentgemma-9b's train steps on (1, 4); tinyllama's train step on a
(16, 16) pod (batch 16) at 16 heads (its own ``dryrun.run_cell`` fails
under jax 0.9's Explicit mesh axes, so every mesh here has Auto axes).
Each is compiled and read with ``hlo_analysis.analyze``, in three
processes started first.  Port side: ``dryrun.trace_cell`` on the same
cells, each
mesh in a fake world of its size in a process of its own
(``tests/torch_dryrun_jobs.py``), so no default process group leaks into
other test files; and ``python -m repro_torch.launch.dryrun --arch
tinyllama-1.1b --shape train_4k --mesh pod --device cpu``, the full-size
cell, in another.

* Per-device FLOPs within ``FLOP_TOL`` (5%) of the reference's where the
  port partitions the work as GSPMD does: tinyllama and gemma2 on every
  mesh, whisper on (1, 1), tinyllama at 16 heads on the pod; the (1, 1) /
  (1, 4) ratio of the train step within ``RATIO_TOL`` (1%) of the
  reference's.  Where the port still computes a block whole on every
  'model' rank (ROADMAP A 12: whisper's attention, whose heads the rules
  leave whole, ``shard_heads`` off; deepseek's MLA; recurrentgemma's
  RG-LRU) only port >= reference is held, and the ratio printed.
* The kinds of collective over 'model' (``collectives_by_axis``) lie
  among the reference's compiled step's; their operand bytes equal the
  step's own ``policy.counts`` (the tensor-parallel blocks', the decode
  merges' and the global norm's), so the two counters agree.
* The full-size cell writes the reference's fields, and its
  ``argument_bytes`` equal rank 0's shard bytes of the params, the AdamW
  state and the batch by ``launch/sharding.py``'s rules on an
  ``AbstractMesh``, computed here apart from the recorder.
* Every collective op the steps can reach has one of the reference's
  kind names, or raises.

About 65 s of wall time on an 8-core host and about 320 s of CPU time
over its eight processes: the reference's 24 compiles about 200 s, the
port's smoke traces about 85 s, the full-size cell about 42 s; ``python
tests/test_torch_dryrun.py`` prints both sides' FLOPs and 'model' bytes,
and with ``--full ARCH:SHAPE ...`` runs those full-size pod cells on both
sides (the reference's at its published config, with its
``memory_analysis()``).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(ROOT, 'tests', 'torch_dryrun_jobs.py')
B, S = 8, 32
FLOP_TOL = 0.05
RATIO_TOL = 0.01
TIMEOUT_S = 300
ARCHS = ('tinyllama-1.1b', 'gemma2-9b', 'whisper-small')
GATHERED = ('deepseek-v3-671b', 'recurrentgemma-9b')
KINDS = ('train', 'prefill', 'decode')
POD16 = {'num_heads': 16, 'num_kv_heads': 16}     # no query head cut on 16


def _cells():
    """name -> (arch, overrides, mesh, info) at the smoke configs."""
    out = {}
    for arch in ARCHS:
        out[f'{arch}/1x1/train'] = (arch, {}, (1, 1),
                                    dict(kind='train', batch=B, seq=S))
        for mesh in ((1, 4), (2, 2)):
            for kind in KINDS:
                out[f'{arch}/{mesh[0]}x{mesh[1]}/{kind}'] = (
                    arch, {}, mesh, dict(kind=kind, batch=B, seq=S))
    for arch in GATHERED:
        out[f'{arch}/1x4/train'] = (arch, {}, (1, 4),
                                    dict(kind='train', batch=B, seq=S))
    out['tinyllama-1.1b/16x16/train/16heads'] = (
        'tinyllama-1.1b', POD16, (16, 16), dict(kind='train', batch=16,
                                                 seq=S))
    return out


CELLS = _cells()
#: the full-size cell: its published config on the pod
FULL = ('tinyllama-1.1b', 'train_4k')
#: cells held to FLOP_TOL; every other cell to port >= reference
CLOSE = tuple(n for n in CELLS if (n.startswith(('tinyllama', 'gemma2'))
                                   and '/16x16/' not in n)
              or n.startswith('whisper-small/1x1')) \
    + ('tinyllama-1.1b/16x16/train/16heads',)
WIDER = tuple(n for n in CELLS if n not in CLOSE)
#: cells where DTensor gathers leaves whole over 'model' (ROADMAP A 12),
#: which the policy counts as leaves, not bytes
GATHER_WHOLE = tuple(n for n in CELLS if n.startswith(GATHERED))

REF_SCRIPT = r"""
import json, jax
from jax.sharding import AxisType
from repro.configs import get_config, get_smoke_config
from repro.launch import specs, steps
from repro.launch.hlo_analysis import analyze
SET = SETTINGS
out = {}
for name, (arch, over, shape, info) in SET['cells'].items():
    full = info.pop('full', False)
    cfg = (get_config if full else get_smoke_config)(arch).replace(**over)
    mesh = jax.make_mesh(tuple(shape), ('data', 'model'),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    specs.SHAPES['cell'] = info
    with mesh:
        if info['kind'] == 'train':
            batch = specs.input_specs(cfg, 'cell')
            fn, _, (p, o, _, _) = steps.build_train_step(cfg, mesh, batch)
            lowered = fn.lower(p, o, batch)
        elif info['kind'] == 'prefill':
            batch = specs.input_specs(cfg, 'cell')
            fn, _, (p, _) = steps.build_prefill_step(cfg, mesh, batch,
                                                     max_len=info['seq'])
            lowered = fn.lower(p, batch)
        else:
            fn, _, (avals, _) = steps.build_serve_step(
                cfg, mesh, batch=info['batch'], max_len=info['seq'],
                long_ctx=info.get('long_ctx', False))
            lowered = fn.lower(*avals)
    compiled = lowered.compile()
    a = analyze(compiled.as_text())
    mem = compiled.memory_analysis()
    out[name] = {'flops': a['flops'], 'collectives': a['collectives'],
                 'argument_bytes': mem.argument_size_in_bytes,
                 'temp_bytes': mem.temp_size_in_bytes}
with open(SET['out'], 'w') as f:
    json.dump(out, f)
"""


def _start(cmd, d, tag, env):
    log = open(os.path.join(d, f'{tag}.log'), 'w')
    return subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=ROOT), log


def _finish(procs, d):
    try:
        for tag, (p, _) in procs.items():
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
            log.close()
    for tag, (p, _) in procs.items():
        if p.returncode != 0:
            with open(os.path.join(d, f'{tag}.log')) as f:
                pytest.fail(f'{tag} exited {p.returncode}:\n'
                            f'{f.read()[-4000:]}')


def run(d, full=(FULL,), smoke=True, ref_full=False):
    """Every process at once; the reference's and the port's results:
    the smoke cells (``smoke``) and the full-size cells ``full`` ((arch,
    shape) on the pod: the port's ``dryrun`` CLI and, with ``ref_full``,
    the reference's step on an Auto-axis mesh of 256 forced devices),
    under ``'full/arch/shape'``."""
    import conftest
    from repro_torch.launch.specs import SHAPES
    procs = {}
    cells = dict(CELLS) if smoke else {}
    ref_parts = {'ref_small': [n for n in cells if '/16x16/' not in n
                               and not n.startswith('whisper')],
                 'ref_whisper': [n for n in cells
                                 if n.startswith('whisper')],
                 'ref_pod': [n for n in cells if '/16x16/' in n]}
    for arch, shape in full if ref_full else ():
        name = f'full/{arch}/{shape}'
        cells[name] = (arch, {}, (16, 16), {**SHAPES[shape], 'full': True})
        ref_parts['ref_pod'].append(name)
    for tag, names in ref_parts.items():
        if not names:
            continue
        settings = {'cells': {n: cells[n] for n in names},
                    'out': os.path.join(d, f'{tag}.json')}
        n_dev = 256 if tag == 'ref_pod' else 4
        procs[tag] = _start([sys.executable, '-c', REF_SCRIPT.replace(
            'SETTINGS', repr(settings))], d, tag,
            conftest.forced_device_env(n_dev))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    meshes = sorted({c[2] for c in CELLS.values()}) if smoke else ()
    for mesh in meshes:
        tag = f'port_{mesh[0]}x{mesh[1]}'
        path = os.path.join(d, f'{tag}.settings.json')
        with open(path, 'w') as f:
            json.dump({'mesh': mesh, 'out': os.path.join(d, f'{tag}.json'),
                       'cells': [[n, a, o, i] for n, (a, o, m, i)
                                 in CELLS.items() if m == mesh]}, f)
        procs[tag] = _start([sys.executable, JOBS, path], d, tag, env)
    out = os.path.join(d, 'full')
    for arch, shape in full:
        procs[f'full_{arch}_{shape}'] = _start(
            [sys.executable, '-m', 'repro_torch.launch.dryrun', '--arch',
             arch, '--shape', shape, '--mesh', 'pod', '--device', 'cpu',
             '--out', out], d, f'full_{arch}_{shape}', env)
    _finish(procs, d)
    ref, port = {}, {}
    for tag in procs:
        if tag.startswith('full'):
            continue
        with open(os.path.join(d, f'{tag}.json')) as f:
            (ref if tag.startswith('ref') else port).update(json.load(f))
    for arch, shape in full:
        with open(os.path.join(out, 'pod', f'{arch}__{shape}.json')) as f:
            port[f'full/{arch}/{shape}'] = json.load(f)
    return {'ref': ref, 'port': port}


@pytest.fixture(scope='module')
def dry(tmp_path_factory):
    return run(str(tmp_path_factory.mktemp('dryrun')))


def _ratio(dry, name):
    return dry['port'][name]['flops'] / dry['ref'][name]['flops']


@pytest.mark.parametrize('name', CLOSE)
def test_per_device_flops_match_reference(dry, name):
    assert abs(_ratio(dry, name) - 1) <= FLOP_TOL, _ratio(dry, name)


@pytest.mark.parametrize('name', WIDER)
def test_per_device_flops_where_blocks_run_whole(dry, name):
    """The port computes more a rank where a block runs whole on every
    'model' rank (ROADMAP A 12); the ratio is printed."""
    r = _ratio(dry, name)
    print(f'{name}: port / reference FLOPs a device {r:.3f}')
    assert r >= 1 - FLOP_TOL


@pytest.mark.parametrize('arch', ('tinyllama-1.1b', 'gemma2-9b'))
def test_flops_ratio_one_to_four_ranks(dry, arch):
    def ratio(side):
        return dry[side][f'{arch}/1x1/train']['flops'] / \
            dry[side][f'{arch}/1x4/train']['flops']
    assert abs(ratio('port') / ratio('ref') - 1) <= RATIO_TOL


def _model_kinds(res):
    return {k for k, by in res['collectives_by_axis'].items()
            if by.get('model')}


@pytest.mark.parametrize('name', [n for n in CELLS
                                  if '/1x1/' not in n])
def test_model_axis_kinds_within_reference(dry, name):
    got = _model_kinds(dry['port'][name])
    want = set(dry['ref'][name]['collectives'])
    assert got and got <= want, (got, want)


@pytest.mark.parametrize('name', [n for n in CELLS if '/1x1/' not in n
                                  and n not in GATHER_WHOLE])
def test_model_axis_bytes_equal_policy_counts(dry, name):
    """op_analysis's operand bytes over 'model' by kind against the step's
    own counts (the global norm's all-reduces counted as ``grad_norm``).
    The cells where DTensor gathers leaves whole over 'model' (ROADMAP
    A 12) are left out: the policy counts those gathers as leaves, not
    bytes; here it counts none."""
    res = dry['port'][name]
    pc = res['policy_counts']
    assert pc.get('gather/model', 0) == 0
    want = {'all-reduce': pc.get('all_reduce_bytes/model', 0)
            + pc.get('grad_norm_bytes/model', 0),
            'all-gather': pc.get('all_gather_bytes/model', 0)}
    got = {k: by.get('model', 0)
           for k, by in res['collectives_by_axis'].items()}
    assert {k: v for k, v in got.items() if v} == \
        {k: v for k, v in want.items() if v}


def test_op_analysis_names_every_collective():
    """Each collective op the steps can reach has one of the reference's
    kinds (DTensor's all-to-all on the card included); a collective of no
    such kind raises; an op that moves nothing is none."""
    import torch.distributed._functional_collectives  # noqa: F401
    import torch.distributed.tensor  # noqa: F401
    from repro_torch.launch.op_analysis import COLL_KINDS, _kind
    ops = torch.ops
    want = {
        ops.c10d.allreduce_.default: 'all-reduce',
        ops.c10d.allgather_.default: 'all-gather',
        ops.c10d.alltoall_base_.default: 'all-to-all',
        ops.c10d.reduce_scatter_.default: 'reduce-scatter',
        ops.c10d.send.default: 'collective-permute',
        ops._c10d_functional.all_gather_into_tensor.default: 'all-gather',
        ops._c10d_functional.all_to_all_single.default: 'all-to-all',
        ops._c10d_functional.reduce_scatter_tensor.default: 'reduce-scatter',
        ops._c10d_functional_autograd.all_to_all_single.default:
            'all-to-all',
        ops._dtensor.shard_dim_alltoall.default: 'all-to-all',
        ops._c10d_functional.wait_tensor.default: None,
        ops.c10d.recv_.default: None,
        ops.aten.mm.default: None,
    }
    for op, kind in want.items():
        assert _kind(op) == kind, op
    assert set(k for k in want.values() if k) == set(COLL_KINDS)
    for op in (ops.c10d.broadcast_.default,
               ops._c10d_functional.broadcast.default):
        with pytest.raises(ValueError, match='no kind'):
            _kind(op)


def test_full_size_cell_record_and_argument_bytes(dry):
    """The CLI's record of tinyllama-1.1b train_4k on the pod: the
    reference's fields, and the rank's argument bytes by the rules."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    rec = dry['port']['full/' + '/'.join(FULL)]
    assert {'arch', 'shape', 'mesh', 'devices', 'flops_per_device',
            'bytes_per_device', 'memory', 'collective_bytes'} <= set(rec)
    assert set(rec['memory']) == {'argument_bytes', 'output_bytes',
                                  'temp_bytes', 'alias_bytes'}
    assert rec['devices'] == 256 and rec['flops_per_device'] > 0
    assert set(rec['collective_bytes']) <= {
        'all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
        'collective-permute'}
    cfg = get_config('tinyllama-1.1b')
    mesh = AbstractMesh((16, 16), ('data', 'model'))
    p = abstract_params(build_model(cfg))
    p_sh = sh.params_shardings(p, cfg, mesh)
    o = adamw(3e-4).init(p)
    batch = input_specs(cfg, 'train_4k')
    pairs = [(p, p_sh), (o, sh.zero1_shardings(o, p_sh, mesh)),
             (batch, sh.batch_shardings(batch, mesh))]
    sizes = mesh.shape
    total = 0
    for avals, shs in pairs:
        for a, s in zip(tree_leaves(avals), tree_leaves(shs)):
            shape = list(a.shape)
            for d, ax in enumerate(s.spec):
                for name in sh._axes(ax):
                    assert shape[d] % sizes[name] == 0
                    shape[d] //= sizes[name]
            total += torch.Size(shape).numel() * a.element_size()
    assert rec['memory']['argument_bytes'] == total
    assert rec['memory']['alias_bytes'] > 0 and rec['memory']['temp_bytes'] > 0


def test_dryrun_import_and_refusal_start_no_world():
    """Importing the module starts no process group and sets no
    environment variable (in a fresh process); without a card, a cell
    asked for the card (the default) fails, and ``main`` exits non-zero,
    leaving no process group."""
    import torch.distributed as dist
    subprocess.run([sys.executable, '-c', (
        'import os; env = dict(os.environ)\n'
        'import torch.distributed as dist\n'
        'import repro_torch.launch.dryrun\n'
        'assert dict(os.environ) == env and not dist.is_initialized()')],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src')),
        check=True, timeout=120)
    if not torch.cuda.is_available():
        from repro_torch.launch import dryrun
        with pytest.raises(SystemExit, match='1 cells failed'):
            dryrun.main(['--arch', 'tinyllama-1.1b', '--shape', 'train_4k'])
    assert not dist.is_initialized()


if __name__ == '__main__':
    # python tests/test_torch_dryrun.py: both sides of every smoke cell;
    # with --full ARCH:SHAPE ...: those full-size cells on the pod only
    import argparse
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument('--full', nargs='*', default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    full = [tuple(c.split(':')) for c in args.full] if args.full else ()
    with tempfile.TemporaryDirectory() as d:
        res = run(d, full=full, smoke=args.full is None, ref_full=True)
    for name in CELLS if args.full is None else ():
        r, p = res['ref'][name], res['port'][name]
        model = {k: v.get('model')
                 for k, v in p['collectives_by_axis'].items()}
        print(f"{name}: FLOPs port {p['flops']:.4g} reference "
              f"{r['flops']:.4g} ({p['flops'] / r['flops']:.3f}); 'model' "
              f"bytes port {model}; reference (every axis) "
              f"{r['collectives']}")
    for arch, shape in full:
        name = f'full/{arch}/{shape}'
        r, p = res['ref'][name], res['port'][name]
        m = p['memory']
        print(json.dumps({
            'cell': name, 'flops_port': p['flops_per_device'],
            'flops_reference': r['flops'],
            'ratio': p['flops_per_device'] / r['flops'],
            'argument_bytes_port': m['argument_bytes'],
            'argument_bytes_reference': r['argument_bytes'],
            'temp_bytes_port': m['temp_bytes'],
            'temp_bytes_reference': r['temp_bytes'],
            'collectives_port': p['collective_bytes'],
            'collectives_reference': r['collectives']}))
