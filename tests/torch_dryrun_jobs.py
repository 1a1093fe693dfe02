"""One fake world of the dry-run checks, run by ``tests/test_torch_dryrun.py``
as ``python tests/torch_dryrun_jobs.py SETTINGS``: this process is rank 0
of a fake world of the mesh's size (``launch/dryrun.fake_world``, no peer
runs), builds each cell's step at the smoke size the settings name and
traces it once under ``op_analysis`` (``dryrun.trace_cell``), on the CPU.
The settings (JSON) give the mesh, the cells (a name, the arch, config
overrides and a ``SHAPES``-style entry) and the output path, where the
results go as JSON.  A prefill cell is traced twice more: under
``'<name>/whole-cache'`` with no cache chunks in the prefill's ctx (each
rank builds the whole cache and cuts it afterwards, the path before the
chunks), and
its cache's global and whole local shapes go under
``'<name>/cache-shapes'``.  It imports neither ``jax`` nor ``repro``.
"""
import json
import sys
import time
import warnings

import torch

torch.set_num_threads(1)
warnings.filterwarnings('ignore')


def whole_cache(cfg, mesh, info):
    """The cell traced with no cache chunks in the prefill's ctx."""
    from repro_torch.launch import dryrun, steps
    made = steps.make_prefill_ctx
    steps.make_prefill_ctx = lambda *a: {**made(*a), 'cache_chunk': None}
    try:
        return dryrun.trace_cell(cfg, mesh, info, device='cpu')
    finally:
        steps.make_prefill_ctx = made


def cache_shapes(cfg, mesh, info):
    """{'global', 'local'}: the cache leaves' global shapes and their
    whole-sequence shapes on this rank's batch chunk, and ``'bytes'``:
    the latter's bytes."""
    from repro_torch.launch.mesh import data_axes, mesh_axes
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves
    model = build_model(cfg)
    sizes = mesh_axes(mesh)
    dp = 1
    for a in data_axes(mesh):
        dp *= sizes[a]
    g = tree_leaves(model.init_cache(info['batch'], info['seq'], 'meta'))
    loc = tree_leaves(model.init_cache(info['batch'] // dp, info['seq'],
                                       'meta'))
    return {'global': [list(t.shape) for t in g],
            'local': [list(t.shape) for t in loc],
            'bytes': sum(t.numel() * t.element_size() for t in loc)}


def main(path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    with open(path) as f:
        s = json.load(f)
    shape = tuple(s['mesh'])
    out = {}
    with dryrun.fake_world(shape[0] * shape[1], device='cpu'):
        mesh = make_mesh(shape, ('data', 'model'), device='cpu')
        for name, arch, over, info in s['cells']:
            t0 = time.perf_counter()
            cfg = get_smoke_config(arch).replace(**over)
            out[name] = dryrun.trace_cell(cfg, mesh, info, device='cpu')
            if info['kind'] == 'prefill':
                out[name + '/whole-cache'] = whole_cache(cfg, mesh, info)
                out[name + '/cache-shapes'] = cache_shapes(cfg, mesh, info)
            print(f'{name}: {time.perf_counter() - t0:.1f} s', flush=True)
    with open(s['out'], 'w') as f:
        json.dump(out, f)


if __name__ == '__main__':
    main(sys.argv[1])
