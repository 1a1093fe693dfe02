"""One rank of the port's multi-rank checks on the CPU (gloo), run by
``tests/test_torch_mesh.py`` as ``python tests/torch_mesh_jobs.py DIR
RANK WORLD``: every rank of a world runs this file at once, reads the
inputs the test wrote to ``DIR/inputs.pt``, joins the process group
through ``file://DIR/pg_WORLD`` and writes what it computed to
``DIR/out_WORLD_RANK.pt``.  It imports neither ``jax`` nor ``repro``.

World 4 ((2, 2) mesh): one ``build_train_step`` step, a prefill and
greedy decode steps through ``build_prefill_step``/``build_serve_step``,
two rounds of
``allreduce_compressed``, ``make_decode_ctx`` at long_ctx off and on, and
a checkpoint of the (2, 2)-placed params.  World 2 ((1, 2) mesh): the
decode ctx, and ``elastic_restore`` of that checkpoint.  World 1 (1 x 1):
the train step and the restore.
"""
import os
import sys
import time

import torch

T0 = time.perf_counter()
torch.set_num_threads(1)


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _locals(tree):
    from repro_torch.tree import tree_leaves
    return [tuple(x.to_local().shape) for x in tree_leaves(tree)]


def train(inp, mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config(inp['arch'])
    batch = {k: torch.as_tensor(v) for k, v in inp['batch'].items()}
    fn, _, _ = steps.build_train_step(cfg, mesh, batch, lr=inp['lr'])
    # the step donates its params (updates them in place): give it copies
    params = tree_map(lambda a: torch.tensor(a), inp['params'])
    params, opt, m = fn(params, adamw(inp['lr']).init(params), batch)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'params': [_full(x) for x in tree_leaves(params)],
            'mu': [_full(x) for x in tree_leaves(opt.mu)],
            'nu': [_full(x) for x in tree_leaves(opt.nu)],
            'step': int(_full(opt.step)),
            'local_params': _locals(params), 'local_mu': _locals(opt.mu)}


def compress(inp, mesh, rank):
    from repro_torch.optim import allreduce_compressed
    group = [mesh.get_group(a) for a in mesh.mesh_dim_names]
    grads = {k: torch.as_tensor(v[rank]) for k, v in inp['grads'].items()}
    mean1, r1 = allreduce_compressed(grads, None, group)
    mean2, r2 = allreduce_compressed(grads, r1, group)
    return {'mean': [mean1, mean2], 'residual': [r1, r2]}


def decode(inp, mesh):
    """Each case: this rank's chunks of the inputs and the cache through
    the ctx; the outputs and the new cache gathered back to full."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serving import decode_spec, make_decode_ctx
    from repro_torch.launch.sharding import NamedSharding, P
    from repro_torch.launch.mesh import data_axes
    from repro_torch.tree import tree_map, tree_map_with_path
    from torch.distributed.tensor import DTensor
    out = {}
    for name, case in inp['decode'].items():
        cfg = get_smoke_config(case['arch'])
        for long_ctx in (False, True):
            dp = data_axes(mesh)
            bspec = None if long_ctx else (dp if len(dp) > 1 else dp[0])
            ctx = make_decode_ctx(
                mesh, cfg, max_len=int(case['cache']['meta']['total']),
                long_ctx=long_ctx)
            shs = tree_map_with_path(
                lambda p, x: NamedSharding(mesh, decode_spec(
                    p, x, mesh, long_ctx=long_ctx)),
                tree_map(torch.as_tensor, case['cache']))
            cache = tree_map(lambda x, s: s.place(torch.as_tensor(x)),
                             case['cache'], shs)
            b_sh = NamedSharding(mesh, P(bspec))
            args = [b_sh.place(torch.as_tensor(a)).to_local()
                    for a in case['args']]
            local = tree_map(lambda x: x.to_local(), cache)
            fn = ctx['decode_mla' if 'ckv' in case['cache'] else
                     'decode_attn']
            res, _ = fn(*args, local, case['cur'], **case['kw'])
            res = DTensor.from_local(res, mesh, b_sh.placements,
                                     run_check=False).full_tensor()
            out[(name, long_ctx)] = {
                'out': res,
                'cache': tree_map(lambda x: x.full_tensor(), cache),
                'local': tree_map(lambda x: tuple(x.to_local().shape),
                                  cache)}
    return out


def serve(inp, mesh):
    """Each case: ``build_prefill_step`` then ``build_serve_step`` for
    ``steps`` greedy tokens, each fed back; the tokens gathered."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    out = {}
    for name, case in inp['serve'].items():
        cfg = get_smoke_config(inp['arch']).replace(
            kv_cache_bits=case['bits'])
        prompt = torch.as_tensor(case['prompt'])
        b, s = prompt.shape
        pre, _, _ = steps.build_prefill_step(
            cfg, mesh, {'tokens': prompt}, max_len=case['max_len'])
        step, _, _ = steps.build_serve_step(
            cfg, mesh, batch=b, max_len=case['max_len'],
            long_ctx=case['long_ctx'])
        params = tree_map(lambda a: torch.tensor(a), inp['params'])
        tok, cache = pre(params, {'tokens': prompt})
        toks = [tok.full_tensor()]
        for t in range(case['steps']):
            tok, cache = step(params, tok, s + t, cache)
            toks.append(tok.full_tensor())
        out[name] = {'tokens': torch.stack(toks),
                     'k_local': tuple(cache['blocks'][0]['k']
                                      .to_local().shape)}
    return out


def spec_fn(inp, mesh):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.sharding import param_spec
    cfg = get_smoke_config(inp['arch'])
    fsdp = tuple(a for a in mesh.mesh_dim_names if a != 'model')
    return lambda p, x: param_spec(p, x, cfg, mesh, fsdp_axes=fsdp)


def save_placed(inp, mesh, d):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime.elastic import reshard_tree, shardings_for
    from repro_torch.tree import tree_map
    params = tree_map(torch.as_tensor, inp['params'])
    placed = reshard_tree(params, shardings_for(params, mesh,
                                                spec_fn(inp, mesh)))
    mgr = CheckpointManager(os.path.join(d, 'elastic'), keep=2)
    mgr.save(7, {'params': placed})
    mgr.wait()
    return _locals(placed)


def restore(inp, mesh, d):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import elastic_restore
    from repro_torch.tree import tree_leaves, tree_map
    like = {'params': tree_map(lambda a: torch.empty(a.shape, device='meta'),
                               inp['params'])}
    mgr = CheckpointManager(os.path.join(d, 'elastic'))
    state, step = elastic_restore(mgr, like, mesh, spec_fn(inp, mesh))
    return {'step': step,
            'full': [_full(x) for x in tree_leaves(state)],
            'local': _locals(state)}


def main():
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    inp = torch.load(os.path.join(d, 'inputs.pt'), weights_only=False)
    init_distributed('cpu', init_method=f'file://{d}/pg_{world}',
                     rank=rank, world_size=world, timeout_s=60)
    shape = {4: (2, 2), 2: (1, 2), 1: (1, 1)}[world]
    mesh = make_mesh(shape, ('data', 'model'), device='cpu')
    out = {}
    if world in (4, 1):
        out['train'] = train(inp, mesh)
        out['serve'] = serve(inp, mesh)
    if world == 4:
        out['compress'] = compress(inp, mesh, rank)
        out['saved_local'] = save_placed(inp, mesh, d)
    if world in (4, 2):
        out['decode'] = decode(inp, mesh)
    if world in (2, 1):
        out['restore'] = restore(inp, mesh, d)
    out['seconds'] = time.perf_counter() - T0
    torch.save(out, os.path.join(d, f'out_{world}_{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
