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

``--deadline-ms`` attaches per-request deadlines and turns on the SLO
layer (deadline admission and graceful degradation through the exit
heads; no admitted request finishes late).  ``--chaos`` serves the trace
on the replica pool under a seeded fault plan (a replica killed mid-batch,
a straggler slowdown) and reports availability, failover and straggler
counters.  Both run on a simulated clock built from stage costs measured
here (CUDA events on the card, after a warm-up).  ``--trace OUT.json``
records the export's and the scheduler's spans, checks their invariants
(``obs.check_trace``) and writes a Chrome trace.

    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --server \\
        --requests 128 --deadline-ms 40 --chaos --replicas 2 --trace t.json

The reference's ``--pipeline`` (ROADMAP queue A item 10) and ``--verify``
(item 7) raise until their slices land.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _measure_stage_costs(model, x, iters=5):
    """Median per-segment batch cost (seconds) at the geometry of ``x``,
    after a warm-up call: CUDA events on the card, ``perf_counter`` on
    the CPU — the simulated clock for --deadline-ms / --chaos runs."""
    from repro_torch.core.export import time_us
    costs, carry = [], x
    with torch.inference_mode():
        for k in range(model.n_stages):
            def run(_k=k, _carry=carry):
                return model.stage_fns[_k](model.params, _carry)
            run()                                     # warm-up off the clock
            costs.append(float(np.median(
                [time_us(run, model.device) for _ in range(iters)])) * 1e-6)
            if k < model.n_stages - 1:
                _, carry = model.run_stage(k, carry)
    return costs


def _serve_trace(model, fam, cfg, args, tracer=None):
    """--server mode: drive the request scheduler over a Poisson trace on
    the wall clock.  --deadline-ms adds the SLO layer and --chaos runs the
    replica pool under a seeded fault plan — both on the simulated clock
    built from locally measured stage costs."""
    from repro_torch.core.export import calibrate_exit_threshold
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.serving import (ChaosPlan, ContinuousBatchScheduler,
                                     ReplicaPoolScheduler, Request,
                                     SLOPolicy)

    rng = np.random.default_rng(args.seed)
    stream = fam.eval_batches(-(-args.requests // args.batch), args.batch)
    xs = torch.cat([x for x, _ in stream])[:args.requests]
    ys = torch.cat([y for _, y in stream])[:args.requests].cpu().numpy()
    threshold = args.threshold
    if threshold is None:
        threshold = calibrate_exit_threshold(model, xs[:args.slots])
        print(f'calibrated exit threshold: {threshold:.4f}')
    t = np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests))
    deadlines = [None] * args.requests
    if args.deadline_ms is not None:
        deadlines = [float(ti) + args.deadline_ms * 1e-3 for ti in t]
    reqs = [Request(i, xs[i], float(t[i]), deadline=deadlines[i])
            for i in range(args.requests)]
    simulated = args.chaos or args.deadline_ms is not None
    if simulated:
        # the SLO layer and the replica pool need a deterministic clock:
        # measure per-segment batch costs here and simulate on them
        costs = _measure_stage_costs(model, xs[:args.slots])
        print('measured stage costs: '
              + ' '.join(f'{c * 1e3:.2f}ms' for c in costs))
        slo = SLOPolicy(stage_costs=costs) \
            if args.deadline_ms is not None else None
        if args.chaos:
            horizon = max(float(t[-1]),
                          args.requests / args.slots * sum(costs)
                          / args.replicas)
            plan = ChaosPlan.seeded(args.chaos_seed, args.replicas, horizon)
            sched = ReplicaPoolScheduler(
                model, slots=args.slots, threshold=threshold,
                stage_costs=costs, slo=slo, replicas=args.replicas,
                min_replicas=args.replicas, max_replicas=args.max_replicas,
                restore=lambda: model, restore_delay=costs[0], chaos=plan,
                tracer=tracer)
        else:
            sched = ContinuousBatchScheduler(
                model, slots=args.slots, threshold=threshold,
                stage_costs=costs, max_wait=args.max_wait, slo=slo,
                tracer=tracer)
    else:
        sched = ContinuousBatchScheduler(model, slots=args.slots,
                                         threshold=threshold,
                                         max_wait=args.max_wait,
                                         tracer=tracer)
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
          f'threshold={threshold:.3f}'
          + (' clock=simulated' if simulated else ''))
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
    if 'slo' in s:
        slo_s = s['slo']
        print(f"  SLO deadline={args.deadline_ms:.1f}ms: "
              f"attainment={slo_s['attainment']:.3f} "
              f"late={slo_s['n_late']} rejected={s['n_rejected']} "
              f"degraded={s['n_degraded']} "
              f"(mix {s['degraded_exit_mix']})")
        if slo_s['n_late']:
            raise RuntimeError(f"never-late contract violated: "
                               f"{slo_s['n_late']} late completions")
    if 'resilience' in s:
        r = s['resilience']
        print(f"  chaos: availability={s['availability']:.4f} "
              f"kills={r['kills']} failovers={r['failovers']} "
              f"straggler_flags={r['straggler_flags']} "
              f"evictions={r['evictions']} "
              f"peak_replicas={r['peak_replicas']}")
    print('  kernel launches while serving: '
          + ' '.join(f"{k}={v['launches']} (plain {v['plain_calls']})"
                     for k, v in counts().items()))
    print('  ' + metrics.telemetry_digest())
    if tracer is not None:
        from repro_torch.obs import check_trace
        check_trace(tracer, completions, strict=True)
        tracer.write(args.trace)
        print(f'  trace: {len(tracer.spans)} spans -> {args.trace} '
              f'(open at https://ui.perfetto.dev)')
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
    ap.add_argument('--deadline-ms', type=float, default=None,
                    help='per-request deadline after arrival; enables the '
                         'SLO layer (deadline admission + graceful '
                         'degradation through the exit heads) on a '
                         'simulated clock from measured stage costs')
    ap.add_argument('--chaos', action='store_true',
                    help='run the replica pool under a seeded fault plan '
                         '(kill + straggler slowdown) and report resilience '
                         'counters; implies --server')
    ap.add_argument('--chaos-seed', type=int, default=0)
    ap.add_argument('--replicas', type=int, default=2,
                    help='--chaos: provisioned replica count')
    ap.add_argument('--max-replicas', type=int, default=4,
                    help='--chaos: elastic scale-up ceiling')
    ap.add_argument('--trace', metavar='OUT.json', default=None,
                    help='record the export and scheduler spans, check '
                         'their invariants and write a Chrome trace')
    ap.add_argument('--pipeline', action='store_true',
                    help='pipeline-parallel serving (not ported yet)')
    ap.add_argument('--verify', nargs='?', const='strict', default=None,
                    choices=('strict', 'warn'),
                    help='static analysis of the export (not ported yet)')
    args = ap.parse_args(argv)
    if args.pipeline:
        ap.error('--pipeline is not ported yet (ROADMAP, queue A item 10: '
                 'distributed and launch code)')
    if args.verify:
        ap.error('--verify is not ported yet (ROADMAP, queue A item 7: '
                 'analysis)')
    if args.chaos:
        args.server = True
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
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    calib = fam.eval_batches(1, args.batch)[0][0]
    model = export_cnn(params, cfg, device=device, calibrate=calib,
                       tracer=tracer)
    s = model.summary()
    print(f"layer plan: {s['n_layers']} layers, {s['kernel_launches']} "
          f"kernel launches (+{s['exit_head_launches']} exit heads), "
          f"{s['n_fused_lowrank']} fused low-rank, {s['n_depthwise']} "
          f"depthwise, {s['total_macs'] / 1e6:.1f} MMACs/image, fallback "
          f"MACs {s['fallback_mac_fraction']:.1%}; segment launches "
          f"{list(model.segment_launches)}")
    _serve_trace(model, fam, cfg, args, tracer=tracer)


if __name__ == '__main__':
    main()
