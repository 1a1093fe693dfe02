#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no result is printed:

1. Card and build: the card's name and power limit, then every CUDA
   source under ``src/repro_torch/kernels/csrc`` compiled with nvcc
   (registers, shared memory and spills from ptxas, and the seconds).
2. Kernels against their plain versions on the card at main-path shapes:
   ``quant_matmul`` at the stem, a stage-0 conv, a stage-3 conv and a
   head, each with the int8 requantize epilogue and with fp32 output, and
   ``fake_quant_fused`` at the three head weights.  Outputs must be
   identical bit for bit.  Each case prints the kernel's time, the plain
   version's, a library yardstick the port never calls
   (``torch._int_mm`` + a torch epilogue, where its shape rules allow) and
   the bound: bytes once in and once out at 3.35 TB/s against the int8
   (or fp32) operations at the card's peak.
3. End to end, the port's main path: resnet34-cifar with exit heads at
   the default stages, ``export_cnn(device='cuda', calibrate=<32
   images>)``, the exit threshold calibrated, and 256 Poisson requests
   served through ``ContinuousBatchScheduler`` at 32 slots.  Every
   request must complete, the quant_matmul launches while serving must
   equal the plan's launches per executed segment, the plain versions
   must not run, 16 sampled requests must be bit-exact against the
   monolithic ``fn_exits`` on the request alone at the same slot geometry,
   and the served logits must agree with the port's plain CPU path on a
   small batch.
4. The ``{"kernels": [...]}`` line: each ported kernel with its launches
   on the main path and its time, plain time, library time and bound,
   summed over the calls one full-depth 32-slot pass makes.

The last line of standard output is ``{"ok": true, "device": {...}}``.
This script imports no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, 'src'))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 peak outside the tensor cores
CONFIG = 'resnet34-cifar'
SLOTS = 32
N_REQUESTS = 256
RATE = 2000.0                  # Poisson arrivals per second
N_ORACLE = 16
SEED = 0


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr)
    sys.exit(1)


def smi_line():
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f'nvidia-smi failed: {r.stderr.strip()}')
    return r.stdout.strip().splitlines()[0]


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_ms(torch, fn, iters=20):
    """Mean milliseconds per call over ``iters`` calls, CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_device(torch, fn):
    """Run ``fn`` under torch.profiler: (wall ms, device kernel ms, top
    kernels by device time).  Device time is None when the profiler saw no
    device activity (it is then not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [(getattr(e, 'device_time_total', 0.0) / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(ms for ms, _, _ in kernels)
    return wall, (busy if kernels else None), sorted(kernels, reverse=True)


def same_bits(torch, a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


# ------------------------------------------------------------------ phase 1


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    secs = time.perf_counter() - t0
    for name, i in info.items():
        print(f"[build] {name}: {'built' if i['built'] else 'cached'} "
              f"-> {os.path.relpath(i['path'], HERE)}")
        for line in i['log'].splitlines():
            if 'Compiling entry' in line:
                print('[build]   ' + re.sub(r".*function '([^']+)'.*", r'\1',
                                            line))
            elif 'registers' in line or 'spill' in line:
                print('[build]     ' + line.strip())
        if 'spill stores' in i['log'] and \
                re.search(r'[1-9]\d* bytes spill stores', i['log']):
            print(f'[build] WARNING: {name} spills registers')
    print(f'[build] {len(info)} CUDA source(s) in {secs:.2f} s')


# ------------------------------------------------------------------ phase 2


def qmm_library(torch, x, w, sx, sw, bias, relu, out_scale, out_qmax):
    """torch._int_mm plus a torch epilogue (the yardstick), or None where
    the product falls outside _int_mm's shape rules."""
    from repro_torch.kernels.ref import requantize
    M, K = x.shape
    N = w.shape[1]
    if M <= 16 or K % 8 or N % 8:
        return None

    def call():
        y = torch._int_mm(x, w).to(torch.float32) * (sx[:, None] * sw)
        if bias is not None:
            y = y + bias
        if relu:
            y = torch.clamp_min(y, 0.0)
        return requantize(y, out_scale, out_qmax) if out_scale else y
    return call


def qmm_case(torch, x, w, sx, sw, bias, relu, out_scale, out_qmax=127.0,
             iters=20):
    """Kernel vs plain version on one call: bit-exactness and times."""
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)
    kw = dict(relu=relu, out_scale=out_scale, out_qmax=out_qmax)
    got = quant_matmul(x, w, sx, sw, bias, **kw)
    want = quant_matmul_plain(x, w, sx, sw, bias, **kw)
    torch.cuda.synchronize()
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
    M, K = x.shape
    N = w.shape[1]
    nbytes = M * K + K * N + 4 * (M + N) + (4 * N if bias is not None else 0) \
        + M * N * (1 if out_scale else 4)
    b_ms, b_by = bound(nbytes, 2 * M * N * K, INT8_OPS_PER_S)
    lib = qmm_library(torch, x, w, sx, sw, bias, relu, out_scale, out_qmax)
    return {
        'shape': (M, K, N), 'int8_out': out_scale is not None,
        'exact': same_bits(torch, got, want), 'max_abs_err': err,
        'ms': time_ms(torch, lambda: quant_matmul(x, w, sx, sw, bias, **kw),
                      iters),
        'plain_ms': time_ms(torch, lambda: quant_matmul_plain(
            x, w, sx, sw, bias, **kw), iters),
        'library_ms': None if lib is None else time_ms(torch, lib, iters),
        'bound_ms': b_ms, 'bound_by': b_by}


def fq_case(torch, w, bits=8, iters=20):
    from repro_torch.kernels.fake_quant import (fake_quant_fused,
                                                fake_quant_plain)
    got = fake_quant_fused(w, bits=bits)
    want = fake_quant_plain(w, bits=bits)
    torch.cuda.synchronize()
    K, N = w.shape
    # abs, max, div, rint, two clips, mul per element; w in, output out
    b_ms, b_by = bound(8 * K * N, 7 * K * N, FP32_OPS_PER_S)
    return {'shape': (K, N), 'exact': same_bits(torch, got, want),
            'max_abs_err': float((got - want).abs().max()),
            'ms': time_ms(torch, lambda: fake_quant_fused(w, bits=bits),
                          iters),
            'plain_ms': time_ms(torch, lambda: fake_quant_plain(w, bits=bits),
                                iters),
            'library_ms': None, 'bound_ms': b_ms, 'bound_by': b_by}


def fmt_case(name, c):
    lib = 'n/a' if c['library_ms'] is None else f"{c['library_ms']:.4f}"
    return (f"[kernel] {name} {c['shape']}"
            + (f" {'int8' if c['int8_out'] else 'fp32'}-out"
               if 'int8_out' in c else '')
            + f": exact={c['exact']} max_abs_err={c['max_abs_err']:g} "
              f"ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
              f"library_ms={lib} bound_ms={c['bound_ms']:.4f} "
              f"({c['bound_by']})")


def phase_kernels(torch):
    g = torch.Generator(device='cuda').manual_seed(SEED)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device='cuda',
                             dtype=torch.int32).to(torch.int8)

    def f32(*shape, scale=1.0):
        return torch.rand(shape, generator=g, device='cuda') * scale

    cases = [('stem', 32 * 32 * 32, 27, 64), ('stage0', 32768, 576, 64),
             ('stage3', 512, 4608, 512), ('head', 32, 512, 10)]
    for name, M, K, N in cases:
        x, w = i8(M, K), i8(K, N)
        sx, sw = f32(M, scale=1e-2), f32(N, scale=1e-2)
        bias = torch.randn(N, generator=g, device='cuda')
        for out_scale in (0.37, None):
            c = qmm_case(torch, x, w, sx, sw, bias, True, out_scale)
            print(fmt_case(f'quant_matmul[{name}]', c))
            if not c['exact']:
                fail(f'quant_matmul disagrees with its plain version at '
                     f'{name} {c["shape"]}')
    for K in (128, 256, 512):
        w = torch.randn((K, 10), generator=g, device='cuda')
        c = fq_case(torch, w)
        print(fmt_case('fake_quant_fused[head]', c))
        if not c['exact']:
            fail(f'fake_quant_fused disagrees with its plain version at '
                 f'{c["shape"]}')


# ------------------------------------------------------------------ phase 3


def phase_serve(torch):
    import numpy as np
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.export import calibrate_exit_threshold, export_cnn
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     exit_decisions)

    fam = CNNFamily(SyntheticImages(), device='cuda')
    cfg = CNN_REGISTRY[CONFIG]
    params = fam.init(torch.Generator().manual_seed(SEED), cfg)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(SEED + 1),
                                params, cfg, fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    stream = fam.eval_batches(N_REQUESTS // 64 + 1, 64)
    xs = torch.cat([x for x, _ in stream])
    calib, xs = xs[:SLOTS], xs[SLOTS:SLOTS + N_REQUESTS]
    rng = np.random.default_rng(SEED)
    t_arr = np.cumsum(rng.exponential(1.0 / RATE, size=N_REQUESTS))
    torch.cuda.synchronize()

    # ---- the main path, counted from zero
    reset_counts()
    t0 = time.perf_counter()
    model = export_cnn(params, cfg, device='cuda', calibrate=calib)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    s = model.summary()
    print(f"[serve] {CONFIG} exported in {t_export:.2f} s: {s['n_layers']} "
          f"layers, {s['kernel_launches']} launches "
          f"(+{s['exit_head_launches']} exit heads), "
          f"{s['total_macs'] / 1e6:.1f} MMACs/image, exit stages "
          f"{cfg.exit_stages}, launches per segment {model.segment_launches}")
    threshold = calibrate_exit_threshold(model, calib)
    print(f'[serve] calibrated exit threshold {threshold:.6f}')
    ContinuousBatchScheduler(model, slots=SLOTS, threshold=2.0).run_trace(
        [Request(-1 - i, xs[i], 0.0) for i in range(4)])     # warm-up
    before = counts()
    torch.cuda.reset_peak_memory_stats()
    sched = ContinuousBatchScheduler(model, slots=SLOTS, threshold=threshold,
                                     max_wait=0.05)
    reqs = [Request(i, xs[i], float(t_arr[i])) for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    completions, metrics = sched.run_trace(reqs)
    t_serve = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    main_counts = counts()

    m = metrics.summary()
    print(f"[serve] served {m['n_requests']} of {N_REQUESTS} requests "
          f"(Poisson {RATE:.0f}/s, {sched.slots} slots) in {t_serve:.3f} s "
          f"wall: throughput {m['throughput_rps']} req/s, p50 "
          f"{m['p50_latency_s'] * 1e3:.3f} ms, p99 "
          f"{m['p99_latency_s'] * 1e3:.3f} ms, exit mix {m['exit_mix']}, "
          f"batches {m['n_batches']}, occupancy {m['batch_occupancy']}, "
          f"peak memory {peak / 2 ** 20:.1f} MiB")
    print(f"[serve] execute p50 {m['p50_execute_s'] * 1e3:.3f} ms p99 "
          f"{m['p99_execute_s'] * 1e3:.3f} ms | queue-wait p50 "
          f"{m['p50_queue_wait_s'] * 1e3:.3f} ms p99 "
          f"{m['p99_queue_wait_s'] * 1e3:.3f} ms")
    if len(completions) != N_REQUESTS:
        fail(f'{N_REQUESTS - len(completions)} requests never completed')
    want = sum(model.segment_launches[k] for k, _, _ in metrics.batches)
    got = main_counts['quant_matmul']['launches'] - \
        before['quant_matmul']['launches']
    plain = sum(main_counts[k]['plain_calls'] - before[k]['plain_calls']
                for k in main_counts)
    print(f'[serve] quant_matmul launches while serving: {got} (plan: {want} '
          f'over {len(metrics.batches)} segment batches); plain-version '
          f'calls while serving: {plain}')
    if got != want:
        fail(f'serving launched quant_matmul {got} times, the plan says '
             f'{want}')
    if plain:
        fail(f'the plain versions ran {plain} times while serving')
    for name, c in main_counts.items():
        if c['launches'] == 0:
            fail(f'{name} was never launched on the main path')

    # the scheduler's contract: each request alone through fn_exits
    for rid in np.linspace(0, N_REQUESTS - 1, N_ORACLE).astype(int):
        x = xs[rid][None]
        xb = torch.cat([x, torch.zeros((SLOTS - 1,) + tuple(x.shape[1:]),
                                       device=x.device)])
        logits, exits = model.fn_exits(model.params, xb)
        stage, ans = exit_decisions(logits, exits, threshold)
        c = completions[int(rid)]
        if int(stage[0]) != c.exit_stage or \
                not np.array_equal(ans[0].view(np.int32),
                                   c.logits.view(np.int32)):
            fail(f'request {rid} differs from the monolithic fn_exits oracle')
    print(f'[serve] {N_ORACLE} sampled requests bit-exact against fn_exits '
          f'on the request alone at {SLOTS} slots')
    seg_ms = {}
    for _, k, _, _, cost in metrics.batch_samples:
        seg_ms.setdefault(k, []).append(cost * 1e3)
    print('[serve] execute ms per segment batch (mean of n): ' + ', '.join(
        f'seg{k} {sum(v) / len(v):.3f} (n={len(v)})'
        for k, v in sorted(seg_ms.items())))

    # where the time goes: the same trace again under the profiler
    def serve_again():
        ContinuousBatchScheduler(model, slots=SLOTS, threshold=threshold,
                                 max_wait=0.05).run_trace(
            [Request(i, xs[i], float(t_arr[i])) for i in range(N_REQUESTS)])
    wall, busy, top = profile_device(torch, serve_again)
    if busy is None:
        print(f'[profile] serving wall {wall:.3f} ms; device time not '
              f'measured (the profiler recorded no device activity)')
    else:
        print(f'[profile] serving wall {wall:.3f} ms, device kernels '
              f'{busy:.3f} ms: device busy {busy / wall:.1%}, idle '
              f'{1 - busy / wall:.1%} (profiled run)')
        for ms, n, name in top[:8]:
            print(f'[profile]   {ms:9.3f} ms  {n:6d} x  {name[:90]}')

    # served logits against the port's plain CPU path on a small batch
    small = calib[:4]
    gpu = export_cnn(params, cfg, device='cuda', calibrate=small)
    cpu = export_cnn(params, cfg, device='cpu', calibrate=small.cpu())
    lg_gpu = gpu.serve(small).cpu()
    lg_cpu = cpu.serve(small.cpu())
    if tuple(lg_gpu.shape) != (4, cfg.num_classes) or \
            not bool(torch.isfinite(lg_gpu).all()):
        fail(f'served logits malformed: shape {tuple(lg_gpu.shape)}')
    scale = max(float(lg_cpu.abs().max()), 1.0)
    diff = float((lg_gpu - lg_cpu).abs().max())
    print(f'[serve] card vs CPU plain path on 4 images: max |diff| {diff:.3e} '
          f'(max |logit| {scale:.3e}, tolerance 4e-2 x that)')
    if diff > 4e-2 * scale:
        fail('served logits disagree with the CPU plain path')
    return model, params, main_counts


# ------------------------------------------------------------------ phase 4


def phase_report(torch, model, params, main_counts):
    """Time each kernel over the calls one full-depth pass makes."""
    from repro_torch.core.export import _resolve_layer_params
    g = torch.Generator(device='cuda').manual_seed(SEED + 7)
    qmax = model.plan.a_qmax
    calls = []
    for name, e in model.plan.layers.items():
        p = _resolve_layer_params(model.params, name)
        if e['kind'] == 'conv':
            B, H, W, C = e['in_shape']
            kh, kw = e['kernel']
            _, oh, ow, n = e['out_shape']
            M, K = B * oh * ow, kh * kw * C
            w = p['w_q'].reshape(K, n)
            out_scale = e['out_scale']
        else:
            M, K = e['in_shape']
            w, n, out_scale = p['w_q'], p['w_q'].shape[1], None
        x = torch.randint(-128, 128, (M, K), generator=g, device='cuda',
                          dtype=torch.int32).to(torch.int8)
        sx = torch.full((M,), e['sx'], device='cuda')
        calls.append(qmm_case(torch, x, w, sx, p['scale'].reshape(-1),
                              p.get('b'), False, out_scale, qmax, iters=10))
    bad = [c['shape'] for c in calls if not c['exact']]
    if bad:
        fail(f'quant_matmul disagrees with its plain version at {bad}')
    fq = [fq_case(torch, params[k]['w'] if k == 'head'
                  else params['exits'][k]['w'])
          for k in ['head'] + sorted(params['exits'])]
    if not all(c['exact'] for c in fq):
        fail('fake_quant_fused disagrees with its plain version')

    def total(cs, key):
        vals = [c[key] for c in cs]
        return None if any(v is None for v in vals) else sum(vals)

    def entry(name, route, source, replaces, cs):
        has_lib = [c for c in cs if c['library_ms'] is not None]
        return {'name': name, 'route': route, 'source': source,
                'replaces': replaces,
                'launches': main_counts[name]['launches'],
                'max_abs_err': max(c['max_abs_err'] for c in cs),
                'ms': total(cs, 'ms'), 'plain_ms': total(cs, 'plain_ms'),
                'bound_ms': total(cs, 'bound_ms'),
                'bound_by': max(('bytes', 'operations'), key=lambda k: sum(
                    c['bound_ms'] for c in cs if c['bound_by'] == k)),
                'library_ms': total(cs, 'library_ms'),
                'calls_per_pass': len(cs),
                'library_ms_where_defined': sum(
                    c['library_ms'] for c in has_lib),
                'ms_where_library_defined': sum(c['ms'] for c in has_lib)}

    for c in calls:
        print(fmt_case('quant_matmul[main-path]', c))
    for c in fq:
        print(fmt_case('fake_quant_fused[main-path]', c))
    return [entry('quant_matmul', 'cuda',
                  'src/repro_torch/kernels/csrc/quant_matmul.cu',
                  'src/repro/kernels/quant_matmul.py:109', calls),
            entry('fake_quant_fused', 'triton',
                  'src/repro_torch/kernels/fake_quant.py',
                  'src/repro/kernels/fake_quant.py:101', fq)]


def main():
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs a '
             'card')
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f'the port (src/repro_torch) is not beside this script: {e}')
    t_start = time.perf_counter()
    print(f'[card] {smi_line()}')
    print(f'[card] torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)} x '
          f'{torch.cuda.device_count()}')
    phase_build()
    phase_kernels(torch)
    model, params, main_counts = phase_serve(torch)
    kernels = phase_report(torch, model, params, main_counts)
    print(f'[done] {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
