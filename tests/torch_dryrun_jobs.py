"""One fake world of the dry-run checks, run by ``tests/test_torch_dryrun.py``
as ``python tests/torch_dryrun_jobs.py SETTINGS``: this process is rank 0
of a fake world of the mesh's size (``launch/dryrun.fake_world``, no peer
runs), builds each cell's step at the smoke size the settings name and
traces it once under ``op_analysis`` (``dryrun.trace_cell``), on the CPU.
The settings (JSON) give the mesh, the cells (a name, the arch, config
overrides and a ``SHAPES``-style entry) and the output path, where the
results go as JSON.  It imports neither ``jax`` nor ``repro``.
"""
import json
import sys
import time
import warnings

import torch

torch.set_num_threads(1)
warnings.filterwarnings('ignore')


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
            print(f'{name}: {time.perf_counter() - t0:.1f} s', flush=True)
    with open(s['out'], 'w') as f:
        json.dump(out, f)


if __name__ == '__main__':
    main(sys.argv[1])
