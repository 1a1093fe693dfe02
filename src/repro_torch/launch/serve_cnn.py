"""CNN serving launcher: export a CNN to the int8 serving path and serve
batched traffic with early exit, or (``--server``) a Poisson trace of
requests through the continuous-batching scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve_cnn \\
        --config resnet8-cifar --batches 8 --batch 64 --threshold 0.85
    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --server \\
        --config resnet34-cifar --requests 256 --rate 2000 --slots 32

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without a card it exits with an error instead of falling back.
Every registered config serves: ``mobilenetv2-cifar`` puts its depthwise
layers on the ``depthwise_conv`` kernel.
The model is a random init with exit heads at the default points,
fine-tuned for ``--steps`` W8A8 QAT steps (default 60, as the reference;
0 serves the raw init).

The default (batch) mode exports with dynamic scales
(``export_cnn(calibrate=None)``), or with ``--resident`` the
int8-resident plan calibrated on the first batch, and serves
``--batches`` caller-assembled batches of the eval stream through
``serve_early_exit`` at ``--threshold`` (default 0.85) (:func:`serve_batches`);
it prints img/s, the accuracy and the exit mix.  The reference's
``--pallas`` has no counterpart: the port runs its kernels whenever the
model is on the card.  ``--server`` (which implies ``--resident``)
prints the layer plan, the throughput, p50/p99 latency, the exit mix and
the kernel launch counts.

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

``--verify [strict|warn]`` runs the analyzer over the export before
serving and prints its report (``strict``, the default, stops on an error
finding); it implies ``--resident``.

``--pipeline`` serves the trace pipeline-parallel across every card of
the host (``serving.pipeline_devices``; with ``--device cpu``, the one
CPU): the placement solver packs stage *k* onto a device by measured
cost (greedy LPT, the reported load-balance bound), the int8 carry moves
between devices, and the run prints the placement next to the usual
latency numbers.  ``--chaos`` composes: a seeded device kill mid-trace,
survivors re-solved; with one device the kill is recorded as
``kill_skipped`` (the last device is never killed).

    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --server \
        --pipeline --chaos --requests 256 --slots 32
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def serve_batches(model, stream, threshold, exit_stages):
    """The batch mode's loop: ``serve_early_exit`` over each (x, y) of
    ``stream``, after one warm-up call off the clock.  Returns (images,
    wall seconds, correct predictions, {exit stage: images that left
    there}); images not counted under a stage left at the final head."""
    model.serve_early_exit(stream[0][0], threshold=threshold)
    stages = {s: 0 for s in exit_stages}
    hit = tot = 0
    sync = torch.cuda.synchronize if model.device.type == 'cuda' else None
    t0 = time.perf_counter()
    for x, y in stream:
        pred, stage = model.serve_early_exit(x, threshold=threshold)
        if sync:
            sync(model.device)
        hit += int((pred.to(y.device) == y).sum())
        tot += int(y.numel())
        stage = np.asarray(stage.cpu() if torch.is_tensor(stage) else stage)
        for s in stages:
            stages[s] += int(np.sum(stage == s))
    return tot, time.perf_counter() - t0, hit, stages


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
                                     PipelineParallelScheduler,
                                     ReplicaPoolScheduler, Request,
                                     SLOPolicy, pipeline_devices)

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
    simulated = args.chaos or args.deadline_ms is not None or args.pipeline
    if simulated:
        # the SLO layer and the replica pool need a deterministic clock:
        # measure per-segment batch costs here and simulate on them
        costs = _measure_stage_costs(model, xs[:args.slots])
        print('measured stage costs: '
              + ' '.join(f'{c * 1e3:.2f}ms' for c in costs))
        slo = SLOPolicy(stage_costs=costs) \
            if args.deadline_ms is not None else None
        if args.pipeline:
            devices = (pipeline_devices() if model.device.type == 'cuda'
                       else (model.device,))
            plan = None
            if args.chaos:
                horizon = max(float(t[-1]),
                              args.requests / args.slots * sum(costs))
                plan = ChaosPlan.seeded(args.chaos_seed, len(devices),
                                        horizon)
            sched = PipelineParallelScheduler(
                model, slots=args.slots, threshold=threshold,
                stage_costs=costs, devices=devices, max_wait=args.max_wait,
                chaos=plan, tracer=tracer)
            p = sched.placement.summary()
            print(f"placement over {p['n_devices']} devices: "
                  f"{p['assignment']} loads={p['loads']} "
                  f"balance={p['balance']} (LPT bound {p['bound']})")
        elif args.chaos:
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
    from repro_torch.analysis import AnalysisError
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.export import export_cnn, resolve_device
    from repro_torch.core.family import CNNFamily
    from repro_torch.core.passes import Trainer
    from repro_torch.data import SyntheticImages

    ap = argparse.ArgumentParser()
    ap.add_argument('--server', action='store_true',
                    help='request-level serving through the continuous-'
                         'batching scheduler; implies --resident')
    ap.add_argument('--config', default='resnet34-cifar',
                    choices=sorted(CNN_REGISTRY))
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--batch', type=int, default=64,
                    help='calibration and stream batch size')
    ap.add_argument('--batches', type=int, default=8,
                    help='batch mode: batches of the eval stream served')
    ap.add_argument('--resident', action='store_true',
                    help='int8-resident plan: calibrate static activation '
                         'scales on the first eval batch (batch mode; '
                         'without it the export takes dynamic scales)')
    ap.add_argument('--steps', type=int, default=60,
                    help='QAT fine-tune steps before export (0 = raw init)')
    ap.add_argument('--threshold', type=float, default=None,
                    help='exit threshold (default 0.85; --server default '
                         'calibrates on the stream)')
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
                    help='pipeline-parallel over every card of the host '
                         '(the CPU with --device cpu): the placement solver '
                         'packs stages onto devices by measured cost, the '
                         'int8 carry moves between them; implies --server '
                         '(simulated clock); composes with --chaos (seeded '
                         'device kill)')
    ap.add_argument('--verify', nargs='?', const='strict', default=None,
                    choices=('strict', 'warn'),
                    help='run the analyzer (repro_torch/analysis) over the '
                         'export before serving and print the report; '
                         'strict (default) aborts on any error finding. '
                         'Implies --resident')
    args = ap.parse_args(argv)
    if args.chaos or args.pipeline:
        args.server = True
    if args.pipeline and args.deadline_ms is not None:
        ap.error('--pipeline does not compose with --deadline-ms (the '
                 'SLO layer lives in the replica pool)')
    if args.server or args.verify:
        args.resident = True
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
    stream = fam.eval_batches(1 if args.server else args.batches,
                              args.batch)
    calib = stream[0][0] if args.resident else None
    try:
        model = export_cnn(params, cfg, device=device, calibrate=calib,
                           verify=args.verify, tracer=tracer)
    except AnalysisError as e:
        print(e.report)
        sys.exit('serve_cnn: the export failed --verify strict')
    if args.verify:
        print(model.analysis)
    if args.resident:
        s = model.summary()
        print(f"layer plan: {s['n_layers']} layers, {s['kernel_launches']} "
              f"kernel launches (+{s['exit_head_launches']} exit heads), "
              f"{s['n_fused_lowrank']} fused low-rank, {s['n_depthwise']} "
              f"depthwise, {s['total_macs'] / 1e6:.1f} MMACs/image, "
              f"fallback MACs {s['fallback_mac_fraction']:.1%}; segment "
              f"launches {list(model.segment_launches)}")
    if args.server:
        return _serve_trace(model, fam, cfg, args, tracer=tracer)
    if tracer is not None:       # batch mode: the export's spans only
        tracer.write(args.trace)
        print(f'trace: {len(tracer.spans)} spans -> {args.trace}')
    threshold = 0.85 if args.threshold is None else args.threshold
    tot, dt, hit, stages = serve_batches(model, stream, threshold,
                                         cfg.exit_stages)
    name = (torch.cuda.get_device_name(model.device)
            if model.device.type == 'cuda' else 'cpu')
    print(f"config={cfg.name} device={name} "
          f"plan={'resident' if args.resident else 'dynamic'}")
    print(f'served {tot} images in {dt:.3f}s ({tot / dt:.0f} img/s), '
          f'acc={hit / max(tot, 1):.3f}')
    for st in sorted(stages):
        print(f'  exit@stage{st}: {stages[st] / max(tot, 1):.1%}')
    print(f'  final head:   {1 - sum(stages.values()) / max(tot, 1):.1%}')


if __name__ == '__main__':
    main()
