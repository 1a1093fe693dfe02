"""Multi-pod dry-run: trace every (arch x shape x mesh) cell at full size on
one rank of a fake world (the reference's ``launch/dryrun.py``).

It shows without the hardware that the distribution config is coherent:
a sharding that does not fit, a collective the mesh code cannot run, or a
data-dependent op that needs the data fails here.  Writes per-cell JSON
(memory, FLOPs and bytes, collective bytes by kind) as the reference does.

The reference forces 512 host devices (``XLA_FLAGS``) and compiles each
cell's jitted step.  The port has one program per rank, so one process
plays one rank (``--rank``, default 0) of a 256-rank (16, 16) or
512-rank (2, 16, 16) world: torch's fake process group over a
``FakeStore`` (``mesh.init_distributed(fake=True)``), where a collective
returns at once.  The mesh is ``mesh.make_production_mesh``'s, the step the
builders' of ``launch/steps.py``, its arguments fake tensors (no memory)
at the cell's full shapes (``specs.SHAPES``), each leaf this rank's shard
as a DTensor on the builder's sharding, and the step runs once under
``op_analysis.OpAnalysis``.  A decode step runs at ``cur`` = the last
position of its cache (every slot valid).

Fields: the reference's, with ``lower_s`` and ``compile_s`` one
``trace_s``, and ``collective_bytes_by_axis`` added.  The reference's
``xla_flops_unscaled`` and ``xla_bytes_unscaled`` (XLA's cost analysis,
which counts a loop body once) have no counterpart and are dropped, and no
``.hlo.gz`` is written.  ``bytes_per_device`` is what the rank's ops
write, eager (``op_analysis``): not the reference's fused-HBM proxy.

Importing this module starts no process group and sets no environment
variable.

Usage:
    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --device cpu
    python -m repro_torch.launch.dryrun --all --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh multipod
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time

import torch


@contextlib.contextmanager
def fake_world(world_size: int, *, rank: int = 0, device='cuda'):
    """This process as ``rank`` of a fake world of ``world_size`` ranks for
    the block; raises where a process group already runs."""
    import torch.distributed as dist
    from repro_torch.core.export import resolve_device
    from repro_torch.launch.mesh import init_distributed
    if dist.is_initialized():
        raise RuntimeError(
            f'a {dist.get_backend()} world of {dist.get_world_size()} ranks '
            f'runs; the dry-run needs a fake world of {world_size}')
    init_distributed(resolve_device(device), fake=True, rank=rank,
                     world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rule_shard_bytes(aval, sharding) -> int:
    """Bytes of rank 0's shard of ``aval`` under the NamedSharding
    ``sharding``, from its spec and the mesh's axis sizes alone: a dim cut
    over axes keeps its first chunk of ceil(n / size) per axis."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.launch.sharding import _axes
    sizes = mesh_axes(sharding.mesh)
    shape = list(aval.shape)
    for d, s in enumerate(sharding.spec):
        for a in _axes(s):
            shape[d] = -(-shape[d] // sizes[a])
    return math.prod(shape) * aval.element_size()


def _fake_arg(aval, sharding, device):
    """A fake DTensor of ``aval``'s global shape on ``sharding``, its
    local shard in storage of its own."""
    from torch.distributed.tensor import DTensor
    full = sharding.place(torch.empty(aval.shape, dtype=aval.dtype,
                                      device=device))
    return DTensor.from_local(full.to_local().clone(), sharding.mesh,
                              full.placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def cell_step(cfg, mesh, info, *, fsdp=True, int8=False, device='cuda'):
    """The cell's step function, and ``(aval, sharding)`` trees of its
    arguments in order (``cur``, a decode step's position, is a Python
    int in their place).  ``info`` is a ``specs.SHAPES`` entry."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.specs import input_specs_for
    if info['kind'] == 'train':
        batch = input_specs_for(cfg, info)
        fn, _, (p_aval, o_aval, p_sh, o_sh) = steps.build_train_step(
            cfg, mesh, batch, fsdp=fsdp)
        return fn, [(p_aval, p_sh), (o_aval, o_sh),
                    (batch, sh.batch_shardings(batch, mesh))]
    if info['kind'] == 'prefill':
        batch = input_specs_for(cfg, info)
        fn, _, (p_aval, p_sh) = steps.build_prefill_step(
            cfg, mesh, batch, max_len=info['seq'], fsdp=fsdp)
        return fn, [(p_aval, p_sh), (batch, sh.batch_shardings(batch, mesh))]
    fn, _, (avals, in_sh) = steps.build_serve_step(
        cfg, mesh, batch=info['batch'], max_len=info['seq'],
        long_ctx=info.get('long_ctx', False), fsdp=fsdp, int8_weights=int8)
    args = list(zip(avals, in_sh))
    args[2] = info['seq'] - 1
    return fn, args


def argument_bytes_by_rule(pairs) -> int:
    """Rank 0's shard bytes of every argument tree, by
    :func:`rule_shard_bytes`."""
    from repro_torch.tree import tree_leaves
    total = 0
    for p in pairs:
        if isinstance(p, int):
            continue
        avals, shs = p
        total += sum(rule_shard_bytes(a, s) for a, s in
                     zip(tree_leaves(avals), tree_leaves(shs)))
    return total


def trace_cell(cfg, mesh, info, *, fsdp=True, int8=False, device='cuda'):
    """Build the cell's step and run it once on fake arguments under
    ``op_analysis``: its result, with ``trace_s``, the argument bytes the
    sharding rules give (``rule_argument_bytes``) and the step's mesh
    policy's counts (``policy_counts``, keys ``'kind/axis'``)."""
    from repro_torch.core.export import resolve_device
    from repro_torch.launch.op_analysis import analyze, fake_mode
    from repro_torch.tree import tree_map
    device = resolve_device(device)
    t0 = time.perf_counter()
    with fake_mode():
        fn, pairs = cell_step(cfg, mesh, info, fsdp=fsdp, int8=int8,
                              device=device)
        args = [p if isinstance(p, int) else
                tree_map(lambda a, s: _fake_arg(a, s, device), *p)
                for p in pairs]
        res = analyze(fn, *args, mesh=mesh)
    res['trace_s'] = round(time.perf_counter() - t0, 1)
    res['rule_argument_bytes'] = argument_bytes_by_rule(pairs)
    res['policy_counts'] = {'/'.join(k): n
                            for k, n in fn.policy.counts.items()}
    return res


def run_cell(arch: str, shape: str, mesh_name: str, *, fsdp=True,
             int8=False, kv8=False, out_dir='experiments/dryrun_torch',
             extra_tag='', device='cuda', rank=0):
    """Dry-run one cell on ``rank`` of a fake world of the mesh's size;
    writes ``<out_dir>/<mesh_name>/<arch>__<shape><extra_tag>.json`` and
    returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import SHAPES
    cfg = get_config(arch)
    if kv8:
        cfg = cfg.replace(kv_cache_bits=8)
    multi = mesh_name == 'multipod'
    with fake_world(512 if multi else 256, rank=rank, device=device):
        mesh = make_production_mesh(multi_pod=multi, device=device)
        ana = trace_cell(cfg, mesh, SHAPES[shape], fsdp=fsdp, int8=int8,
                         device=device)
    res = {
        'arch': arch, 'shape': shape, 'mesh': mesh_name,
        'devices': int(mesh.size()),
        'flops_per_device': ana['flops'],
        'bytes_per_device': ana['bytes'],
        'memory': ana['memory'],
        'collective_bytes': ana['collectives'],
        'collective_bytes_by_axis': ana['collectives_by_axis'],
        'rule_argument_bytes': ana['rule_argument_bytes'],
        'trace_s': ana['trace_s'],
    }
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    tag = f'{arch}__{shape}{extra_tag}.json'
    with open(os.path.join(out_dir, mesh_name, tag), 'w') as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch')
    ap.add_argument('--shape')
    ap.add_argument('--mesh', default='pod', choices=['pod', 'multipod'])
    ap.add_argument('--all', action='store_true')
    ap.add_argument('--no-fsdp', action='store_true')
    ap.add_argument('--int8', action='store_true')
    ap.add_argument('--kv8', action='store_true')
    ap.add_argument('--out', default='experiments/dryrun_torch')
    ap.add_argument('--tag', default='')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--rank', type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch.specs import cells
    todo = cells(ARCH_NAMES) if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape in todo:
        try:
            run_cell(arch, shape, args.mesh, fsdp=not args.no_fsdp,
                     int8=args.int8, kv8=args.kv8, out_dir=args.out,
                     extra_tag=args.tag, device=args.device, rank=args.rank)
        except Exception as e:                                # noqa: BLE001
            failures.append((arch, shape, repr(e)))
            print(f'FAIL {arch} {shape}: {e!r}')
    if failures:
        raise SystemExit(f'{len(failures)} cells failed: {failures}')


if __name__ == '__main__':
    main()
