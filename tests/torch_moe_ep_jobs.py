"""One rank of the port's expert-parallel MoE checks on the CPU (gloo), run
by ``tests/test_torch_moe_ep.py`` as ``python tests/torch_moe_ep_jobs.py
DIR RANK WORLD``: every rank of a world runs this file at once, reads the
inputs the test wrote to ``DIR/inputs.pt``, joins the process group
through ``file://DIR/pg_WORLD`` and writes what it computed to
``DIR/out_WORLD_RANK.pt``.  It imports neither ``jax`` nor ``repro``.

World 8 ((2, 4) mesh): each block case's ``moe_block`` under the mesh
policy on this rank's batch chunk, its params placed on the sharding
rules' specs (``LocalShard`` chunks, as the train step hands them), the
output and the gradients of ``sum(out * ct)`` gathered back to full, and
which collectives ran; then the same under ``REPRO_MOE_MODE=dense``.
World 4 ((2, 2) mesh): one ``build_train_step`` step of each MoE arch.
"""
import os
import sys
import time

import torch

T0 = time.perf_counter()
torch.set_num_threads(1)


def _full(x, mesh=None, placements=None):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.full_tensor()
    if mesh is not None:
        return DTensor.from_local(x, mesh, placements,
                                  run_check=False).full_tensor()
    return x


class _Calls:
    """Counts the EP path's collectives by wrapping their ``apply``."""

    def __init__(self):
        from repro_torch.models import moe
        self.n = {}
        for name in ('_AllToAll', '_Sum', '_SeqGather', '_SeqSlice'):
            fn = getattr(moe, name)
            orig = fn.apply

            def apply(*a, _orig=orig, _name=name):
                self.n[_name] = self.n.get(_name, 0) + 1
                return _orig(*a)
            fn.apply = apply

    def take(self):
        out, self.n = dict(self.n), {}
        return out


def block(inp, mesh, calls):
    """Each case on this rank: (output chunk, full grads, collectives)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models.actsharding import (LocalShard,
                                                activation_sharding,
                                                gather_params,
                                                make_mesh_policy)
    from repro_torch.models.moe import moe_block
    from repro_torch.tree import tree_map, tree_map_with_path
    dp = mesh.get_local_rank('data')
    out = {}
    for name, case in inp['block'].items():
        cfg = get_smoke_config(case['arch']).replace(**case['cfg'])
        tree = {'moe': tree_map(torch.tensor, case['params'])}
        shs = sh.params_shardings(tree, cfg, mesh)
        shards = tree_map(
            lambda x, s: LocalShard(
                s.place(x).to_local().detach().requires_grad_(), mesh,
                s.placements), tree, shs)
        x = torch.tensor(case['x'])
        n = x.shape[0] // mesh.size(0)
        xl = x[dp * n:(dp + 1) * n].clone().requires_grad_()
        ct = torch.tensor(case['ct'])[dp * n:(dp + 1) * n]
        pairs = []                       # (path, LocalShard)
        tree_map_with_path(lambda p, sh_: pairs.append(
            ('/'.join(str(k) for k in p), sh_)), shards['moe'])
        for mode in ('auto', 'dense'):
            os.environ['REPRO_MOE_MODE'] = mode
            calls.take()
            with activation_sharding(make_mesh_policy(mesh)):
                y = moe_block(gather_params(shards)['moe'], xl, cfg)
            grads = torch.autograd.grad(
                (y * ct).sum(), [xl] + [s.local for _, s in pairs],
                allow_unused=True, materialize_grads=True)
            out[(name, mode)] = {
                'y': y.detach(), 'dp': dp, 'x_grad': grads[0],
                'grads': {p: _full(g, mesh, s.placements)
                          for (p, s), g in zip(pairs, grads[1:])},
                'local': {p: tuple(s.local.shape) for p, s in pairs},
                'calls': calls.take()}
    os.environ['REPRO_MOE_MODE'] = 'auto'
    return out


def train(inp, mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    out = {}
    for arch, case in inp['train'].items():
        cfg = get_smoke_config(arch)
        batch = {k: torch.as_tensor(v) for k, v in case['batch'].items()}
        fn, _, _ = steps.build_train_step(cfg, mesh, batch, lr=inp['lr'])
        params = tree_map(lambda a: torch.tensor(a), case['params'])
        params, opt, m = fn(params, adamw(inp['lr']).init(params), batch)
        out[arch] = {'loss': float(m['loss']),
                     'grad_norm': float(m['grad_norm']),
                     'params': [_full(x) for x in tree_leaves(params)],
                     'mu': [_full(x) for x in tree_leaves(opt.mu)],
                     'nu': [_full(x) for x in tree_leaves(opt.nu)]}
    return out


def main():
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    inp = torch.load(os.path.join(d, 'inputs.pt'), weights_only=False)
    init_distributed('cpu', init_method=f'file://{d}/pg_{world}',
                     rank=rank, world_size=world, timeout_s=60)
    shape = {8: (2, 4), 4: (2, 2)}[world]
    mesh = make_mesh(shape, ('data', 'model'), device='cpu')
    out = {}
    if world == 8:
        out['block'] = block(inp, mesh, _Calls())
    else:
        out['train'] = train(inp, mesh)
    out['seconds'] = time.perf_counter() - T0
    torch.save(out, os.path.join(d, f'out_{world}_{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
