"""One rank of the MLA and RG-LRU tensor-parallel checks on the CPU
(gloo), run by ``tests/test_torch_tp_mla_rglru.py`` as ``python
tests/torch_tp_mla_rglru_jobs.py DIR RANK WORLD``: every rank of a world
runs this file at once, reads the inputs the test wrote to
``DIR/inputs.pt``, joins the process group through
``file://DIR/pg_WORLD`` (a 60 s collective timeout) and writes what it
computed to ``DIR/out_WORLD_RANK.pt``.  It imports neither ``jax`` nor
``repro``.

World 4, a (1, 4) mesh: for each arch of ``inputs['archs']`` (the smoke
deepseek-v3-671b and recurrentgemma-9b) one ``build_train_step`` step on
its 'model' shards and on the gather path (the policy's ``tp`` set to
None: every leaf gathered whole), each with its per-rank FLOPs
(``FlopCounterMode``) and its policy's counts; then
``build_prefill_step`` + ``steps`` tokens of ``build_serve_step`` both
ways, the tokens, the prefill's cache and the last cache gathered whole.
World 1 (1 x 1): each arch's train step and its FLOPs.
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


def _gather_path(fn, tp):
    if not tp:
        fn.policy.tp = None
    return fn


def train(inp, mesh, arch, tp=True):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import from_jax_params
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    c = inp['archs'][arch]
    batch = {k: torch.as_tensor(v) for k, v in c['batch'].items()}
    fn = _gather_path(steps.build_train_step(
        get_smoke_config(arch), mesh, batch, lr=inp['lr'])[0], tp)
    p = from_jax_params(c['params'])
    with FlopCounterMode(display=False) as fc:
        p, o, m = fn(p, adamw(inp['lr']).init(p), batch)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'params': [_full(x) for x in tree_leaves(p)],
            'mu': [_full(x) for x in tree_leaves(o.mu)],
            'nu': [_full(x) for x in tree_leaves(o.nu)],
            'flops': fc.get_total_flops(), 'counts': dict(fn.policy.counts),
            'tp': fn.policy.tp is not None}


def serve(inp, mesh, arch, tp):
    """Prefill + ``steps`` greedy tokens, each fed back."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import from_jax_params
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(arch)
    s = inp['serve']
    prompt = torch.as_tensor(inp['archs'][arch]['prompt'])
    b, n = prompt.shape
    pre = _gather_path(steps.build_prefill_step(
        cfg, mesh, {'tokens': prompt}, max_len=s['max_len'])[0], tp)
    step = _gather_path(steps.build_serve_step(
        cfg, mesh, batch=b, max_len=s['max_len'])[0], tp)
    params = from_jax_params(inp['archs'][arch]['params'])
    tok, cache = pre(params, {'tokens': prompt})
    first = tree_map(lambda x: _full(x).clone(), cache)
    toks = [tok.full_tensor()]
    for t in range(s['steps']):
        tok, cache = step(params, tok, n + t, cache)
        toks.append(tok.full_tensor())
    return {'tokens': torch.stack(toks), 'prefill_cache': first,
            'cache': tree_map(lambda x: _full(x).clone(), cache),
            'counts': (dict(pre.policy.counts), dict(step.policy.counts))}


def main():
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    inp = torch.load(os.path.join(d, 'inputs.pt'), weights_only=False)
    init_distributed('cpu', init_method=f'file://{d}/pg_{world}',
                     rank=rank, world_size=world, timeout_s=60)
    out = {}
    mesh = make_mesh((1, world), ('data', 'model'), device='cpu')
    for arch in inp['archs']:
        for tp in ((True, False) if world == 4 else (True,)):
            out['train', arch, tp] = train(inp, mesh, arch, tp)
            if world == 4:
                out['serve', arch, tp] = serve(inp, mesh, arch, tp)
    out['seconds'] = time.perf_counter() - T0
    torch.save(out, os.path.join(d, f'out_{world}_{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
