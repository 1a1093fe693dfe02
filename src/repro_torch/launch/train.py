"""Production training launcher (the reference's ``launch/train.py``).

Builds the sharded train step for ``--arch`` (``launch/steps.py``), runs
the fault-tolerant loop (``runtime/ft.py``) with async checkpointing
(``CheckpointManager(--ckpt, keep=3)``), and with ``--drill`` injects a
failure at the middle step, from which the loop restores the latest
checkpoint and replays.  Prints ``finished at step N; restarts=R; loss a
-> b``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --smoke --mesh 2,2 --device cpu --steps 4 --drill

The mesh: ``--smoke`` gives the reduced config on ``make_local_mesh`` (one
rank); without it the published config on ``make_production_mesh`` ((16,
16), or (2, 16, 16) with ``--multi-pod``) when the world has 256 (512)
ranks, and on a world of one rank, the card, the 1 x 1 mesh at the
published config: the single-device form of the production run, as
``launch/serve.py`` is of the reference's serving.  ``--mesh D,M`` (the
port's addition) lays the running world out as a (data, model) mesh of
that shape, for a multi-rank run of any size (``torchrun`` on the CPU).
The process group comes from ``torchrun``'s environment, or is a world of
one rank in this process (``launch/mesh.init_distributed``).

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without a card it exits with an error instead of falling back.
Every rank draws the same weights (seed 0) and the same global batch of
``SyntheticTokens`` (step ``s`` from a generator seeded ``s``); the step
keeps each rank's chunk.  The reference's docstring mentions a
``--compress DPQE`` that its ``main`` does not have; the port has none
either (the chain runs through ``examples/chain_lm.py``).
``main`` returns ((params, opt_state), the end step, the loop) for a
caller in the same process.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.export import resolve_device
from repro_torch.data import SyntheticTokens
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     make_mesh, make_production_mesh)
from repro_torch.runtime import FaultTolerantLoop, SimulatedFailure
from repro_torch.tree import tree_map


def build_mesh(args, device):
    import torch.distributed as dist
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split(','))
        return make_mesh(shape, ('data', 'model'), device=device)
    if args.smoke or dist.get_world_size() == 1:
        return make_local_mesh(device)
    return make_production_mesh(multi_pod=args.multi_pod, device=device)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default='tinyllama-1.1b', choices=ARCH_NAMES)
    ap.add_argument('--smoke', action='store_true',
                    help='reduced config + 1x1 mesh')
    ap.add_argument('--multi-pod', action='store_true')
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--ckpt', default=os.path.join(tempfile.gettempdir(),
                                                   'repro_torch_ckpt'))
    ap.add_argument('--ckpt-every', type=int, default=25)
    ap.add_argument('--drill', action='store_true',
                    help='inject a failure mid-run (recovery drill)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--mesh', default=None, metavar='D,M',
                    help='a (data, model) mesh of this shape over the '
                         'running world')
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f'train: {e}')
    import torch.distributed as dist
    started = init_distributed(device.type)
    try:
        return _run(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, device):
    import torch.distributed as dist
    mesh = build_mesh(args, device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = SyntheticTokens(vocab=cfg.vocab_size)

    def batch_fn(step):
        return data.batch(torch.Generator().manual_seed(step), args.batch,
                          args.seq)

    fn, model, (_, o_aval, p_sh, o_sh) = steps_lib.build_train_step(
        cfg, mesh, batch_fn(0), lr=args.lr)
    with torch.no_grad():
        params = steps_lib.place_tree(model.init(
            torch.Generator(device=device).manual_seed(0), device), p_sh)
    # AdamW's zero state straight onto its placements a leaf at a time: no
    # unplaced copy of the moments (twice the params) sits beside them
    opt_state = tree_map(lambda a, s: steps_lib.place(
        torch.zeros(a.shape, dtype=a.dtype, device=device), s), o_aval, o_sh)

    def step_fn(state, batch):
        params, opt_state = state
        params, opt_state, metrics = fn(params, opt_state, batch)
        return (params, opt_state), {'loss': float(metrics['loss'])}

    injected = {'done': False}

    def injector(step):
        if args.drill and step == args.steps // 2 \
                and not injected['done']:
            injected['done'] = True
            raise SimulatedFailure('drill: simulated node loss')

    loop = FaultTolerantLoop(
        step_fn=step_fn, batch_fn=batch_fn,
        ckpt=CheckpointManager(args.ckpt, keep=3),
        ckpt_every=args.ckpt_every,
        failure_injector=injector if args.drill else None)
    state, end = loop.run((params, opt_state), 0, args.steps)
    losses = [e[3]['loss'] for e in loop.events if e[0] == 'step']
    if dist.get_rank() == 0:
        print(f'finished at step {end}; restarts={loop.restarts}; '
              f'loss {losses[0]:.3f} -> {losses[-1]:.3f}')
    return state, end, loop


if __name__ == '__main__':
    main()
