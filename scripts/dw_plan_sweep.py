#!/usr/bin/env python3
"""The depthwise kernel's tile route across launch plans.

At mobilenetv2-cifar's seven depthwise shapes at 32 slots and its x2
channel-multiplier case, this script launches ``dw_tile_kernel`` through
its C entry point with the plan ``dw_plan`` picks, the same plan at every
box width from the narrowest the runs need to 8 columns (16 with a
multiplier) wider, the plans around it (slices of 64 and 128 channels
beside the pick's, runs of 2 and 4 output columns, every band of up to 256
threads) and the general kernel.  The library builds only the ``dp4a``
kernel, so the script also builds a copy of its source under ``build/``
whose tile kernel unpacks every byte and sums the taps by 9 int32 IMADs
an output (``IMAD_BODY``; the committed kernel is not touched), prints its
registers as ptxas reports them, and runs ``dw_plan``'s pick on it.  Each
output is checked bit for bit against the plain version (int8 output,
ReLU, bias).  Times are device microseconds a call from CUDA events around
a burst of launches queued behind a sleep kernel (so the host's launch
cost stays off the clock), the candidates timed in turns over several
rounds, the median and the range over the rounds kept.  Prints the card's
name and power limit, each candidate's time beside the byte bound, the box
widths side by side, and the best plan beside ``dw_plan``'s pick.  Needs
one card and nvcc:

    python3 scripts/dw_plan_sweep.py
"""
from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'src'))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw  # noqa: E402
from repro_torch.kernels.ref import recip32, same_pads  # noqa: E402

# (x (B, H, W, CIN), COUT, stride)
SHAPES = (((32, 32, 32, 96), 96, 1), ((32, 32, 32, 96), 96, 2),
          ((32, 16, 16, 144), 144, 1), ((32, 16, 16, 144), 144, 2),
          ((32, 8, 8, 192), 192, 1), ((32, 8, 8, 192), 192, 2),
          ((32, 4, 4, 384), 384, 1), ((32, 16, 16, 48), 96, 1))
ROUNDS = 11
ITERS = 30
SLEEP_CYCLES = 4_000_000       # about 2 ms: the burst is queued meanwhile

# The library kernel's multiply-adds: three taps of a row packed by prmt
# and summed by __dp4a.  The IMAD copy puts IMAD_BODY in their place.
DP4A_BODY = '''\
        // At stride 1 the interleave of the window's last two columns is
        // the next output's first two: every other step reuses it.
        uint32_t p[4];
        if (S == 1 && k % 2 == 1) {
          ils[i][q] = il(win[i][1].v[q], win[i][2].v[q]);
          left(win[i][0].v[q], ils[i][q], p);
        } else {
          if (S != 1 || k == 0)
            ils[i][q] = il(win[i][0].v[q], win[i][1].v[q]);
          right(ils[i][q], win[i][2].v[q], p);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int u = 0; u < MULT; ++u) {
            const int c = (4 * q + m) * MULT + u;
            acc[c] = __dp4a(static_cast<int>(p[m]),
                            static_cast<int>(wp[i][c]), acc[c]);
          }
'''
IMAD_BODY = '''#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int xv = static_cast<int8_t>(win[i][j].v[q] >> (8 * m));
#pragma unroll
            for (int u = 0; u < MULT; ++u) {
              const int c = (4 * q + m) * MULT + u;
              acc[c] += xv * static_cast<int8_t>(wp[i][c] >> (8 * j));
            }
          }
'''
ILS = '''  Il ils[3][4 / MULT];        // a row's interleaved column pair
'''


def imad_source():
    src = (_build.CSRC / 'depthwise_conv.cu').read_text()
    for text, new in ((DP4A_BODY, IMAD_BODY), (ILS, '')):
        if src.count(text) != 1:
            raise SystemExit(f'marker not found once in depthwise_conv.cu: '
                             f'{text[:60]!r}')
        src = src.replace(text, new)
    return src


def build_imad():
    """The IMAD copy, compiled under build/; prints its tile kernels'
    registers and spills.  Returns its tile launcher."""
    out = _build.BUILD_ROOT / 'dw_sweep'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'dw_imad.cu').write_text(imad_source())
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, '-I',
                        str(_build.CSRC), '-o', str(out / 'libdw_imad.so'),
                        str(out / 'dw_imad.cu')], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    fn = '?'
    for line in (r.stdout + r.stderr).splitlines():
        if 'Compiling entry' in line:
            fn = re.sub(r".*function '([^']+)'.*", r'\1', line)
        elif 'dw_tile_kernel' in fn and re.search(r'Used \d+ registers',
                                                  line):
            print(f'IMAD copy {fn}: {line.split(":", 1)[1].strip()}')
    lib = ctypes.CDLL(str(out / 'libdw_imad.so'))
    launch = lib.depthwise_conv_tile_launch
    launch.argtypes, launch.restype = dw._ARGTYPES_TILE, ctypes.c_int
    return launch


def box_plans(pick, stride, mult, ow):
    """The pick at every box width from the narrowest its runs need to
    8 * mult columns wider (the pick's own width excluded)."""
    need = (-(-ow // pick.cols) * pick.cols - 1) * stride + 3
    c, _, h = pick.box
    return [(f'dw_plan box_w={bw}',
             pick._replace(box=(c, bw, h),
                           smem_bytes=dw.dw_smem_bytes(c, bw, h)))
            for bw in range(need, need + 8 * mult)
            if bw != pick.box[1] and bw <= dw.DW_MAX_BOX]


def candidates(B, H, W, C, N, stride):
    """(label, plan): dw_plan's pick, the pick at other box widths, then
    every tile plan around it that fits."""
    pick = dw.dw_plan(B, H, W, C, N, 3, 3, stride)
    (_, _), (oh, ow) = same_pads(H, W, 3, 3, stride)
    out = [('dw_plan', pick)] + box_plans(pick, stride, N // C, ow)
    tall = 1 << (oh - 1).bit_length()
    for groups in sorted({4, 8, pick.slice // 16}):
        for cols in dw.DW_COLS:
            if cols > max(ow, 2):
                continue
            rows = 1
            while rows <= tall:
                p = dw.dw_tile_plan(B, H, W, C, N, stride, groups=groups,
                                    cols=cols, rows=rows)
                if p is not None and all(p != q for _, q in out):
                    out.append(('', p))
                rows *= 2
    return out


def launch_fn(x, w, sw, bias, out, stride, plan, tile_fn=None):
    """One launch of the plan's kernel through its C entry point (the
    library's, or ``tile_fn`` for a tile plan; int8 output on 0.37, ReLU,
    qmax 127)."""
    B, H, W, C = x.shape
    n = w.shape[3]
    (ph, pw), (oh, ow) = same_pads(H, W, 3, 3, stride)
    head = (x.data_ptr(), w.data_ptr(), sw.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, C, n)
    epi = (0.05, recip32(0.37), 127.0, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    if plan.route == 'tile':
        fn = tile_fn or dw._launcher('depthwise_conv_tile_launch',
                                     dw._ARGTYPES_TILE)
        args = (*head, stride, ph[0], pw[0], oh, ow, *epi, plan.slice // 16,
                plan.rows, plan.cols, plan.threads, plan.box[1],
                plan.box[2], plan.smem_bytes, stream)
    else:
        fn = dw._launcher('depthwise_conv_launch', dw._ARGTYPES)
        args = (*head, 3, 3, stride, ph[0], pw[0], oh, ow, *epi,
                int(n == C), stream)

    def call():
        rc = fn(*args)
        if rc:
            raise SystemExit(f'launch failed ({rc}): {plan}')
    return call


def device_us(calls):
    """Device microseconds a call of each entry, timed in turns: (median,
    min, max) over the rounds."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = [[] for _ in calls]
    for _ in range(ROUNDS):
        for i, call in enumerate(calls):
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(ITERS):
                call()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) * 1e3 / ITERS)
    return [(statistics.median(t), min(t), max(t)) for t in times]


def fmt(plan):
    if plan.route == 'general':
        return 'general kernel'
    return (f'slice={plan.slice} rows={plan.rows} cols={plan.cols} '
            f'threads={plan.threads} blocks='
            f'{plan.grid[0] * plan.grid[1] * plan.grid[2]} box={plan.box}')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    imad = build_imad()
    g = torch.Generator(device='cuda').manual_seed(0)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g, device='cuda',
                             dtype=torch.int32).to(torch.int8)
    for (B, H, W, C), N, stride in SHAPES:
        x, w = i8(B, H, W, C), i8(3, 3, 1, N)
        sw = torch.rand(N, generator=g, device='cuda') * 1e-2
        bias = torch.randn(N, generator=g, device='cuda')
        want = dw.depthwise_conv_plain(x, w, 0.05, sw, bias, stride=stride,
                                       relu=True, out_scale=0.37)
        (_, _), (oh, ow) = same_pads(H, W, 3, 3, stride)
        bound_us = (x.numel() + w.numel() + 8 * N + want.numel()) / \
            3.35e12 * 1e6
        cands = candidates(B, H, W, C, N, stride)
        cands = cands + [('dw_plan imad', cands[0][1]),
                         ('general', dw._general_plan(B, oh, ow, N))]
        calls, exact = [], []
        for label, plan in cands:
            out = torch.empty_like(want)
            call = launch_fn(x, w, sw, bias, out, stride, plan,
                             imad if label == 'dw_plan imad' else None)
            out.zero_()
            call()
            torch.cuda.synchronize()
            exact.append(bool(torch.equal(out, want)))
            calls.append(call)
        us = device_us(calls)
        print(f'(B,H,W,C)=({B},{H},{W},{C}) COUT={N} stride={stride}: '
              f'byte bound {bound_us:.2f} us, {len(cands)} candidates')
        for (label, plan), (t, lo, hi), ok in sorted(
                zip(cands, us, exact), key=lambda c: c[1][0]):
            print(f'  {t:7.2f} us [{lo:.2f}-{hi:.2f}] exact={ok} {fmt(plan)}'
                  f'{f" ({label})" if label else ""}')
        if not all(exact):
            raise SystemExit('a plan disagrees with the plain version')
        widths = sorted((p.box[1], t, lo, hi)
                        for (label, p), (t, lo, hi) in zip(cands, us)
                        if label.startswith('dw_plan')
                        and label != 'dw_plan imad')
        print('  box widths: ' + ', '.join(
            f'{bw}{"*" if bw == cands[0][1].box[1] else ""} {t:.2f} '
            f'[{lo:.2f}-{hi:.2f}]' for bw, t, lo, hi in widths) +
            ' us (* dw_plan\'s)')
        tile = [(t[0], p) for (label, p), t in zip(cands, us)
                if p.route == 'tile' and label != 'dw_plan imad']
        best_t, best = min(tile, key=lambda c: c[0])
        print(f'  best {best_t:.2f} us: {fmt(best)}; dw_plan {us[0][0]:.2f} '
              f'us ({us[0][0] / best_t - 1:+.1%}); imad {us[-2][0]:.2f} us; '
              f'general {us[-1][0]:.2f} us')


if __name__ == '__main__':
    main()
