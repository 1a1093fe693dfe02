"""Time one export's serving segments on the card, to compare two trees of
the port in one chip call (run it under each tree's ``src`` in turns:
parent, change, change, parent).

    PYTHONPATH=src python3 scripts/stage_cost_ab.py [--config resnet34-cifar]

Exports the config with exit heads at the default stages, W8A8, random
weights from seed 0, ``export_cnn(device='cuda', calibrate=<32 images>)``,
then reads ``serve_cnn._measure_stage_costs`` (CUDA events around each
segment, after a warm-up) ``--reps`` times and ``fn`` on the same batch
``--reps`` times, and prints one JSON line: the card's name and power
limit, the tree's ``src`` path, and the medians and quartiles in ms.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _quartiles(xs):
    xs = sorted(xs)
    n = len(xs)
    return {'p25': xs[n // 4], 'median': xs[n // 2], 'p75': xs[3 * n // 4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--config', default='resnet34-cifar')
    ap.add_argument('--reps', type=int, default=21)
    ap.add_argument('--tag', default='')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit('stage_cost_ab: needs a CUDA card')
    import repro_torch
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.export import export_cnn, time_us
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    from repro_torch.launch.serve_cnn import _measure_stage_costs

    fam = CNNFamily(SyntheticImages(), device='cuda')
    cfg = CNN_REGISTRY[args.config]
    params = fam.init(torch.Generator().manual_seed(0), cfg)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                cfg, fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    x = fam.eval_batches(1, 32)[0][0]
    model = export_cnn(params, cfg, device='cuda', calibrate=x)
    stages = [_measure_stage_costs(model, x) for _ in range(args.reps)]
    with torch.inference_mode():
        model.fn(model.params, x)
        fn_ms = [time_us(lambda: model.fn(model.params, x), model.device)
                 * 1e-3 for _ in range(args.reps)]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        'tag': args.tag, 'card': smi,
        'src': os.path.dirname(os.path.dirname(repro_torch.__file__)),
        'config': cfg.name, 'reps': args.reps,
        'stage_ms': [_quartiles([s[k] * 1e3 for s in stages])
                     for k in range(model.n_stages)],
        'sum_ms': _quartiles([sum(s) * 1e3 for s in stages]),
        'fn_ms': _quartiles(fn_ms)}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
