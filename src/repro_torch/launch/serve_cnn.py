"""CNN serving launcher: export a CNN to the int8-resident plan and serve a
Poisson trace of requests through the continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --server \\
        --config resnet34-cifar --requests 256 --rate 2000 --slots 32

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without a card it exits with an error instead of falling back.
Every registered config serves: ``mobilenetv2-cifar`` puts its depthwise
layers on the ``depthwise_conv`` kernel.
The model is a random init with exit heads at the default points,
fine-tuned for ``--steps`` W8A8 QAT steps (default 60, as the reference;
0 serves the raw init).  Prints the layer plan, the throughput, p50/p99
latency, the exit mix and the kernel launch counts.  Only ``--server``
mode is ported.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _serve_trace(model, fam, cfg, args):
    from repro_torch.core.export import calibrate_exit_threshold
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.serving import ContinuousBatchScheduler, Request

    rng = np.random.default_rng(args.seed)
    stream = fam.eval_batches(-(-args.requests // args.batch), args.batch)
    xs = torch.cat([x for x, _ in stream])[:args.requests]
    ys = torch.cat([y for _, y in stream])[:args.requests].cpu().numpy()
    threshold = args.threshold
    if threshold is None:
        threshold = calibrate_exit_threshold(model, xs[:args.slots])
        print(f'calibrated exit threshold: {threshold:.4f}')
    t = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    reqs = [Request(i, xs[i], float(t[i])) for i in range(args.requests)]
    sched = ContinuousBatchScheduler(model, slots=args.slots,
                                     threshold=threshold,
                                     max_wait=args.max_wait)
    # warm every segment off the clock: threshold 2.0 exits nobody
    ContinuousBatchScheduler(model, slots=args.slots, threshold=2.0) \
        .run_trace([Request(-1 - i, xs[i], 0.0)
                    for i in range(min(4, args.requests))])
    reset_counts()
    completions, metrics = sched.run_trace(reqs)
    s = metrics.summary()
    hit = sum(1 for i, c in completions.items() if c.pred == int(ys[i]))
    device = (torch.cuda.get_device_name(model.device)
              if model.device.type == 'cuda' else 'cpu')
    print(f'config={cfg.name} device={device} slots={sched.slots} '
          f'threshold={threshold:.3f}')
    print(f"served {s['n_requests']} requests at rate={args.rate:.0f}/s: "
          f"throughput={s['throughput_rps']:.0f} req/s "
          f"p50={s['p50_latency_s'] * 1e3:.2f}ms "
          f"p99={s['p99_latency_s'] * 1e3:.2f}ms "
          f"acc={hit / max(len(completions), 1):.3f}")
    print(f"  exit mix: {s['exit_mix']}  "
          f"occupancy: {s['batch_occupancy']}")
    print(f"  latency split: queue-wait p50={s['p50_queue_wait_s'] * 1e3:.2f}"
          f"ms p99={s['p99_queue_wait_s'] * 1e3:.2f}ms | execute "
          f"p50={s['p50_execute_s'] * 1e3:.2f}ms "
          f"p99={s['p99_execute_s'] * 1e3:.2f}ms")
    print('  kernel launches while serving: '
          + ' '.join(f"{k}={v['launches']} (plain {v['plain_calls']})"
                     for k, v in counts().items()))
    print('  ' + metrics.telemetry_digest())
    return completions, metrics


def main(argv=None):
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.export import export_cnn, resolve_device
    from repro_torch.core.family import CNNFamily
    from repro_torch.core.passes import Trainer
    from repro_torch.data import SyntheticImages

    ap = argparse.ArgumentParser()
    ap.add_argument('--server', action='store_true',
                    help='request-level serving through the continuous-'
                         'batching scheduler (the only ported mode)')
    ap.add_argument('--config', default='resnet34-cifar',
                    choices=sorted(CNN_REGISTRY))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--batch', type=int, default=64,
                    help='calibration and stream batch size')
    ap.add_argument('--steps', type=int, default=60,
                    help='QAT fine-tune steps before export (0 = raw init)')
    ap.add_argument('--threshold', type=float, default=None,
                    help='exit threshold (default: calibrated on the stream)')
    ap.add_argument('--requests', type=int, default=256)
    ap.add_argument('--rate', type=float, default=2000.0,
                    help='Poisson arrival rate (req/s)')
    ap.add_argument('--slots', type=int, default=32)
    ap.add_argument('--max-wait', type=float, default=0.05,
                    help='run a partial batch once its oldest request has '
                         'waited this long (seconds)')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    if not args.server:
        ap.error('only --server mode is ported (ROADMAP, queue A)')
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f'serve_cnn: {e}')

    fam = CNNFamily(SyntheticImages(), device=str(device))
    cfg = CNN_REGISTRY[args.config]
    params = fam.init(torch.Generator().manual_seed(args.seed), cfg)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(args.seed + 1),
                                params, cfg, fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    if args.steps:
        trainer = Trainer(batch=args.batch, steps=args.steps)
        params, loss = trainer.fit(fam, cfg, params)
        print(f'QAT: {args.steps} steps of {args.batch} images, last loss '
              f'{loss:.4f}')
    calib = fam.eval_batches(1, args.batch)[0][0]
    model = export_cnn(params, cfg, device=device, calibrate=calib)
    s = model.summary()
    print(f"layer plan: {s['n_layers']} layers, {s['kernel_launches']} "
          f"kernel launches (+{s['exit_head_launches']} exit heads), "
          f"{s['n_fused_lowrank']} fused low-rank, {s['n_depthwise']} "
          f"depthwise, {s['total_macs'] / 1e6:.1f} MMACs/image, fallback "
          f"MACs {s['fallback_mac_fraction']:.1%}; segment launches "
          f"{list(model.segment_launches)}")
    _serve_trace(model, fam, cfg, args)


if __name__ == '__main__':
    main()
