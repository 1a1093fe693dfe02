"""One rank of the tensor-parallel checks on the CPU (gloo), run by
``tests/test_torch_tp.py`` as ``python tests/torch_tp_jobs.py DIR RANK
WORLD``: every rank of a world runs this file at once, reads the inputs
the test wrote to ``DIR/inputs.pt``, joins the process group through
``file://DIR/pg_WORLD`` and writes what it computed to
``DIR/out_WORLD_RANK.pt``.  It imports neither ``jax`` nor ``repro``.

World 4: on a (1, 4) mesh one ``build_train_step`` step of each case
(the smoke tinyllama, whose 2 kv heads of 32 the 'model' axis cuts, and
the same at 4 kv heads, one a rank), each on its 'model' shards and, for
the first, on the gather path (the policy's ``tp`` set to None: every
leaf gathered whole); on a (2, 2) mesh the first case; then
``build_prefill_step`` + ``build_serve_step`` on (1, 4) both ways, and
the other archs' steps both ways (``archs``).  World 1 (1 x 1): the first
case's step.  Each step's per-rank FLOPs (``FlopCounterMode``) and its
policy's counts go with it.
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
    """``fn`` (a step), on the gather path unless ``tp``."""
    if not tp:
        fn.policy.tp = None
    return fn


def train(inp, mesh, case, tp=True):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map
    c = inp['train'][case]
    cfg = get_smoke_config(inp['arch']).replace(**c['cfg'])
    batch = {k: torch.as_tensor(v) for k, v in inp['batch'].items()}
    fn = _gather_path(steps.build_train_step(cfg, mesh, batch,
                                             lr=inp['lr'])[0], tp)
    # the step donates its params (updates them in place): give it copies
    params = tree_map(lambda a: torch.tensor(a), c['params'])
    opt = adamw(inp['lr']).init(params)
    with FlopCounterMode(display=False) as fc:
        params, opt, m = fn(params, opt, batch)
    return {'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
            'params': [_full(x) for x in tree_leaves(params)],
            'mu': [_full(x) for x in tree_leaves(opt.mu)],
            'nu': [_full(x) for x in tree_leaves(opt.nu)],
            'flops': fc.get_total_flops(), 'counts': dict(fn.policy.counts),
            'tp': fn.policy.tp is not None}


def serve(inp, mesh, tp):
    """Each case: ``build_prefill_step`` then ``build_serve_step`` for
    ``steps`` greedy tokens, each fed back; the tokens gathered, and the
    first step's logits of both."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    out = {}
    for name, case in inp['serve'].items():
        cfg = get_smoke_config(inp['arch']).replace(
            kv_cache_bits=case['bits'])
        prompt = torch.as_tensor(case['prompt'])
        b, s = prompt.shape
        pre = _gather_path(steps.build_prefill_step(
            cfg, mesh, {'tokens': prompt}, max_len=case['max_len'])[0], tp)
        step = _gather_path(steps.build_serve_step(
            cfg, mesh, batch=b, max_len=case['max_len'],
            long_ctx=case['long_ctx'])[0], tp)
        params = tree_map(lambda a: torch.tensor(a),
                          inp['train']['cut']['params'])
        tok, cache = pre(params, {'tokens': prompt})
        toks = [tok.full_tensor()]
        for t in range(case['steps']):
            tok, cache = step(params, tok, s + t, cache)
            toks.append(tok.full_tensor())
        out[name] = {'tokens': torch.stack(toks),
                     'cache': tree_map(lambda x: _full(x).clone(), cache),
                     'counts': (dict(pre.policy.counts),
                                dict(step.policy.counts))}
    return out


def archs(inp, mesh):
    """Each arch of ``inp['archs']`` (smoke, the reference's weights and
    batch): one ``build_train_step`` step on the 'model' shards and on
    the gather path; and, for ``inp['int8']``, 3 ``build_serve_step``
    tokens with the reference's int8 weights both ways."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import from_jax_params
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves
    out = {}
    for arch, c in inp['archs'].items():
        cfg = get_smoke_config(arch)
        batch = {k: torch.as_tensor(v) for k, v in c['batch'].items()}
        for tp in (True, False):
            fn = _gather_path(steps.build_train_step(
                cfg, mesh, batch, lr=inp['lr'])[0], tp)
            p = from_jax_params(c['params'])
            p, o, m = fn(p, adamw(inp['lr']).init(p), batch)
            out['train', arch, tp] = {
                'loss': float(m['loss']), 'grad_norm': float(m['grad_norm']),
                'params': [_full(x) for x in tree_leaves(p)],
                'mu': [_full(x) for x in tree_leaves(o.mu)],
                'nu': [_full(x) for x in tree_leaves(o.nu)],
                'counts': dict(fn.policy.counts)}
    for arch, c in inp['int8'].items():
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        toks = torch.as_tensor(c['tokens'])
        b = toks.shape[0]
        enc = []
        if 'frames' in c:
            enc = [model.encode(from_jax_params(c['params']),
                                torch.as_tensor(c['frames']))]
        for tp in (True, False):
            step = _gather_path(steps.build_serve_step(
                cfg, mesh, batch=b, max_len=16, int8_weights=True)[0], tp)
            cache = model.init_cache(b, 16, 'cpu')
            tok, got = toks[:, 0], []
            for t in range(3):
                tok, cache = step(from_jax_params(c['q']), tok, t, cache,
                                  *enc)
                got.append(tok.full_tensor())
            out['int8', arch, tp] = (torch.stack(got),
                                     dict(step.policy.counts))
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
        out['train', (1, 4), 'cut'] = train(inp, m14, 'cut')
        out['train', (1, 4), 'whole'] = train(inp, m14, 'whole')
        out['train', (1, 4), 'gather'] = train(inp, m14, 'cut', tp=False)
        out['serve', True] = serve(inp, m14, True)
        out['serve', False] = serve(inp, m14, False)
        out['archs'] = archs(inp, m14)
        m22 = make_mesh((2, 2), ('data', 'model'), device='cpu')
        out['train', (2, 2), 'cut'] = train(inp, m22, 'cut')
    else:
        m11 = make_mesh((1, 1), ('data', 'model'), device='cpu')
        out['train', (1, 1), 'cut'] = train(inp, m11, 'cut')
    out['seconds'] = time.perf_counter() - T0
    torch.save(out, os.path.join(d, f'out_{world}_{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
