#!/usr/bin/env python3
"""The fused low-rank kernel's TMA + wgmma route across launch plans.

At factored resnet34-cifar's eight fused shapes at 32 slots (ranks from the
factorization at energy 0.6), this script launches ``lr_wgmma_kernel``
through its C entry point with the plan ``lr_plan`` picks and the plans
around it (clusters of 1-8 blocks, the v stage's 32 or 64 COUT columns,
rings of 1-4 stages, whatever fits two blocks an SM), u and v K-major as
the export stores them, checks each output bit for bit against the plain
version and prints each plan's device time under torch.profiler beside the
byte bound.  Prints the card's name and power limit.  Needs one card and
nvcc:

    python3 scripts/lr_plan_sweep.py
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'src'))

from repro_torch.kernels import lowrank_conv as lr  # noqa: E402
from repro_torch.kernels.ref import recip32  # noqa: E402

SHAPES = ((32768, 576, 30, 64), (8192, 576, 52, 128), (8192, 1152, 59, 128),
          (8192, 64, 20, 128), (2048, 1152, 103, 256),
          (2048, 2304, 118, 256), (2048, 128, 41, 256), (512, 256, 82, 512))


def device_us(fn, iters=50):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and 'lr_wgmma_kernel' in e.key)
    return total / iters


def plans(M, K1, R, N):
    """lr_plan's plan first, then every (VN, stages, C) around it that fits
    two blocks an SM."""
    pick = lr.lr_plan(M, K1, R, N)
    _, rp, *_ = pick
    out = [pick]
    nk = -(-K1 // lr.LR_BK)
    for c in (1, 2, 4, 8):
        for vn in lr.LR_VNS:
            for stages in range(1, min(lr.LR_MAX_STAGES, -(-nk // c)) + 1):
                smem = lr.lr_smem_bytes(rp, vn, stages, c)
                plan = (lr.LR_BM, rp, vn, stages, c, smem)
                if 2 * (smem + 1024) <= lr.LR_SM_SMEM and plan != pick:
                    out.append(plan)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    launch = lr._launcher('lowrank_conv_wgmma_launch', lr._ARGTYPES_WGMMA)
    g = torch.Generator(device='cuda').manual_seed(0)
    for M, K1, R, N in SHAPES:
        def i8(*shape):
            return torch.randint(-128, 128, shape, generator=g, device='cuda',
                                 dtype=torch.int32).to(torch.int8)
        x, u, v = i8(M, K1), i8(R, K1).t(), i8(N, R).t()
        su = torch.rand(R, generator=g, device='cuda') * 1e-3
        sv = torch.rand(N, generator=g, device='cuda') * 1e-2
        bu = torch.randn(R, generator=g, device='cuda')
        bv = torch.randn(N, generator=g, device='cuda')
        want = lr.lowrank_conv_plain(x, u, v, su, sv, bu, bv, sx=0.05,
                                     h_scale=0.9, relu=True, out_scale=0.37)
        out = torch.empty_like(want)
        bound_us = (M * K1 + K1 * R + R * N + 8 * (R + N) + M * N) / \
            3.35e12 * 1e6
        print(f'(M,K1,R,N)=({M},{K1},{R},{N}): byte bound {bound_us:.2f} us')
        for i, plan in enumerate(plans(M, K1, R, N)):
            def call(plan=plan):
                rc = launch(x.data_ptr(), u.data_ptr(), v.data_ptr(),
                            su.data_ptr(), bu.data_ptr(), sv.data_ptr(),
                            bv.data_ptr(), out.data_ptr(), M, K1, R, N, 0.05,
                            0.9, recip32(0.9), 127.0, 1, 1, recip32(0.37),
                            127.0, *plan,
                            torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f'launch failed: {rc}')
            out.zero_()
            call()
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, want))
            us = device_us(call)
            _, rp, vn, stages, c, smem = plan
            print(f'  RP={rp} VN={vn} stages={stages} C={c} smem={smem} '
                  f'blocks={c * -(-M // lr.LR_BM)}'
                  f'{" (lr_plan)" if i == 0 else ""}: {us:.2f} us, '
                  f'exact={exact}')


if __name__ == '__main__':
    main()
