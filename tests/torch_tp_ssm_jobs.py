"""One rank of the Mamba-2 tensor-parallel checks on the CPU (gloo), run by
``tests/test_torch_tp_ssm.py`` as ``python tests/torch_tp_ssm_jobs.py DIR
RANK WORLD``: every rank of a world runs this file at once, reads the
inputs the test wrote to ``DIR/inputs.pt``, joins the process group
through ``file://DIR/pg_WORLD`` (a 60 s collective timeout) and writes
what it computed to ``DIR/out_WORLD_RANK.pt``.  It imports neither
``jax`` nor ``repro``.

World 4, a (1, 4) mesh: one ``build_train_step`` step of each case of
``inputs['train']`` (the smoke mamba2-2.7b; the smoke tinyllama at a
vocab 'model' does not divide) on its 'model' shards and on the gather
path (the policy's ``tp`` set to None: every leaf gathered whole), each
with its per-rank FLOPs (``FlopCounterMode``) and its policy's counts;
then
``build_prefill_step`` + ``steps`` tokens of ``build_serve_step`` both
ways, the tokens, the prefill's cache and the last cache gathered whole;
then the prefill of each case of ``inputs['prefill']`` (the smoke
tinyllama and gemma2, fp32 and int8 caches) built as each rank's chunk of
the cache and, with no cache chunks in the prefill's ctx, whole and cut
afterwards (the path before the chunks).  World 1 (1 x 1): the train step's FLOPs.
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


def train(inp, mesh, case, tp=True):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import from_jax_params
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    c = inp['train'][case]
    cfg = get_smoke_config(c['arch']).replace(**c['over'])
    batch = {k: torch.as_tensor(v) for k, v in c['batch'].items()}
    fn = _gather_path(steps.build_train_step(cfg, mesh, batch,
                                             lr=inp['lr'])[0], tp)
    p = from_jax_params(c['params'])
    with FlopCounterMode(display=False) as fc:
        p, o, m = fn(p, adamw(inp['lr']).init(p), batch)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'params': [_full(x) for x in tree_leaves(p)],
            'mu': [_full(x) for x in tree_leaves(o.mu)],
            'nu': [_full(x) for x in tree_leaves(o.nu)],
            'flops': fc.get_total_flops(), 'counts': dict(fn.policy.counts),
            'tp': fn.policy.tp is not None}


def serve(inp, mesh, tp):
    """Prefill + ``steps`` greedy tokens, each fed back."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import from_jax_params
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    cfg = get_smoke_config('mamba2-2.7b')
    s = inp['serve']
    prompt = torch.as_tensor(s['prompt'])
    b, n = prompt.shape
    pre = _gather_path(steps.build_prefill_step(
        cfg, mesh, {'tokens': prompt}, max_len=s['max_len'])[0], tp)
    step = _gather_path(steps.build_serve_step(
        cfg, mesh, batch=b, max_len=s['max_len'])[0], tp)
    params = from_jax_params(inp['train']['ssm']['params'])
    with FlopCounterMode(display=False) as fc:
        tok, cache = pre(params, {'tokens': prompt})
    first = tree_map(lambda x: _full(x).clone(), cache)
    toks = [tok.full_tensor()]
    for t in range(s['steps']):
        tok, cache = step(params, tok, n + t, cache)
        toks.append(tok.full_tensor())
    return {'tokens': torch.stack(toks), 'prefill_cache': first,
            'cache': tree_map(lambda x: _full(x).clone(), cache),
            'prefill_flops': fc.get_total_flops(),
            'counts': (dict(pre.policy.counts), dict(step.policy.counts))}


def prefill_chunks(inp, mesh):
    """Each case's prefill cache gathered whole: built as this rank's
    chunk (``'chunk'``) and whole, then cut (``'whole'``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    out = {}
    for name, c in inp['prefill'].items():
        cfg = get_smoke_config(c['arch']).replace(
            kv_cache_bits=c['bits'], **c['over'])
        prompt = torch.as_tensor(c['prompt'])
        for how in ('chunk', 'whole'):
            fn = steps.build_prefill_step(cfg, mesh, {'tokens': prompt},
                                          max_len=c['max_len'])[0]
            params = tree_map(torch.tensor, c['params'])
            made = steps.make_prefill_ctx
            if how == 'whole':
                steps.make_prefill_ctx = lambda *a: {**made(*a),
                                                     'cache_chunk': None}
            try:
                tok, cache = fn(params, {'tokens': prompt})
            finally:
                steps.make_prefill_ctx = made
            out[name, how] = (tok.full_tensor(),
                              tree_map(lambda x: _full(x).clone(), cache))
    return out


def main():
    d, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    inp = torch.load(os.path.join(d, 'inputs.pt'), weights_only=False)
    init_distributed('cpu', init_method=f'file://{d}/pg_{world}',
                     rank=rank, world_size=world, timeout_s=60)
    out = {}
    if world == 4:
        m14 = make_mesh((1, 4), ('data', 'model'), device='cpu')
        for case in inp['train']:
            for tp in (True, False):
                out['train', case, tp] = train(inp, m14, case, tp)
        out['serve', True] = serve(inp, m14, True)
        out['serve', False] = serve(inp, m14, False)
        out['prefill'] = prefill_chunks(inp, m14)
    else:
        m11 = make_mesh((1, 1), ('data', 'model'), device='cpu')
        out['train', 'ssm', True] = train(inp, m11, 'ssm')
    out['seconds'] = time.perf_counter() - T0
    torch.save(out, os.path.join(d, f'out_{world}_{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
