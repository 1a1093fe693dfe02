#!/usr/bin/env python3
"""quant_matmul's TMA + wgmma kernel across launch plans, phase by phase.

For resnet34-cifar's conv shapes at 32 slots (and an M tail), this script
launches ``qmm_wgmma_kernel`` through its C entry point with every plan
around the one ``qmm_plan`` picks (BN, ring stages, cluster size C),
checks each output bit for bit against ``quant_matmul_plain``, and prints
for each plan: the kernel's device time under torch.profiler, how many of
its clusters the card holds at once (cudaOccupancyMaxActiveClusters), and
the mean cycles of each phase of a block.  The library takes only the
plans ``qmm_plan`` makes, so the script builds two copies of its source
beside the kernels under ``build/`` (the committed kernel is not
touched): one that also takes BN 128, clusters of 8 and rings of 8 and
has an occupancy entry point, for the times, and the same with thread 0
of every block recording ``clock64()`` at each phase boundary, for the
phases.  Prints the card's name and power limit.  Needs one card and
nvcc:

    python3 scripts/qmm_plan_sweep.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'src'))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import quant_matmul as qm  # noqa: E402

SHAPES = ((32768, 576, 64), (8192, 1152, 128), (2048, 2304, 256),
          (512, 4608, 512), (300, 4608, 512))      # (M, K, N)
PHASES = ('set-up', 'main loop', 'partials + cluster barrier',
          'cluster sum + epilogue', 'final cluster barrier')
STAMPS = '''
__device__ unsigned long long g_stamps[16384 * 8];
#define STAMP(i) do { if (threadIdx.x == 0) { \\
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \\
                  blockIdx.x; \\
  g_stamps[blk * 8 + (i)] = clock64(); } } while (0)
'''
# How many clusters of C wgmma blocks (BN columns, smem_bytes of shared
# memory each) the card can hold at once, into *clusters.
OCCUPANCY = '''
extern "C" int quant_matmul_wgmma_max_clusters(int bn, int C, int smem_bytes,
                                               int* clusters) {
  // The limit is raised to the card's most, never lowered under a limit
  // that the launcher has set.
  int dev = 0, most = 0;
  cudaError_t e0 = cudaGetDevice(&dev);
  if (e0 == cudaSuccess)
    e0 = cudaDeviceGetAttribute(&most,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  auto occupancy = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1024);
    cfg.blockDim = dim3(WG_THREADS, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
  };
  auto by_c = [&](auto k1, auto k2, auto k4, auto k8) {
    switch (C) {
      case 1: return occupancy(k1);
      case 2: return occupancy(k2);
      case 4: return occupancy(k4);
      case 8: return occupancy(k8);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (bn) {
    case 32:
      return by_c(qmm_wgmma_kernel<32, 1>, qmm_wgmma_kernel<32, 2>,
                  qmm_wgmma_kernel<32, 4>, qmm_wgmma_kernel<32, 8>);
    case 64:
      return by_c(qmm_wgmma_kernel<64, 1>, qmm_wgmma_kernel<64, 2>,
                  qmm_wgmma_kernel<64, 4>, qmm_wgmma_kernel<64, 8>);
    case 128:
      return by_c(qmm_wgmma_kernel<128, 1>, qmm_wgmma_kernel<128, 2>,
                  qmm_wgmma_kernel<128, 4>, qmm_wgmma_kernel<128, 8>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
'''

# (text in the kernel, the stamps that go after it), applied in order.  The
# unsplit kernel (C = 1) has no cluster barrier: its partials phase is the
# block barrier before the epilogue, its final barrier phase is empty.
MARKS = (
    ('const __grid_constant__ CUtensorMap tw, const WgArgs a) {\n', (0,)),
    ('    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: '
     '"memory");\n  }\n  __syncthreads();\n', (1,)),
    ('  __syncthreads();            // the ring is drained: the partials '
     'overlay it\n', (2,)),
    ('    // accumulators, two neighbouring columns at a time.\n'
     '    __syncthreads();\n', (3,)),
    ('                       bs[c + 1], a.relu));\n      }\n    }\n', (4, 5)),
    ('    cluster.sync();\n', (3,)),
    ('      if (n0 + col + 2 < a.N) store2(a, m, n0 + col + 2, y[2], '
     'y[3]);\n    }\n', (4,)),
    ('    cluster_sync_relaxed();   // every block\'s partials stay until '
     'read\n', (5,)),
)


# (text in the kernel, its replacement): the plans beyond qmm_plan's.
WIDER = (
    ('constexpr int WG_MAX_CLUSTER = 4;', 'constexpr int WG_MAX_CLUSTER = 8;'),
    ('constexpr int WG_MAX_STAGES = 4;', 'constexpr int WG_MAX_STAGES = 8;'),
    ('    case 4: return launch_wgmma<BN_, 4>(tx, tw, a, smem, st);\n',
     '    case 4: return launch_wgmma<BN_, 4>(tx, tw, a, smem, st);\n'
     '    case 8: return launch_wgmma<BN_, 8>(tx, tw, a, smem, st);\n'),
    ('    case 64: return launch_wgmma_bn<64>(x, w, a, C, smem, st);\n',
     '    case 64: return launch_wgmma_bn<64>(x, w, a, C, smem, st);\n'
     '    case 128: return launch_wgmma_bn<128>(x, w, a, C, smem, st);\n'),
)


def _replace_once(src, text, new, what):
    if src.count(text) != 1:
        raise SystemExit(f'marker for {what} not found once: {text!r}')
    return src.replace(text, new)


def wider_source():
    src = (_build.CSRC / 'quant_matmul.cu').read_text()
    for text, new in WIDER:
        src = _replace_once(src, text, new, 'the wider plans')
    return src + OCCUPANCY


def instrumented_source():
    src = wider_source()
    src = src.replace('namespace {\n', 'namespace {\n' + STAMPS, 1)
    for text, stamps in MARKS:
        src = _replace_once(src, text, text + ''.join(
            f'  STAMP({i});\n' for i in stamps), f'stamps {stamps}')
    return src + '''
extern "C" int read_stamps(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_stamps, sizeof(unsigned long long) * n));
}
'''


def build():
    """Both copies, compiled together: {'wide': lib, 'phased': lib}."""
    out = _build.BUILD_ROOT / 'qmm_sweep'
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
    procs = {}
    for name, src in (('wide', wider_source()),
                      ('phased', instrumented_source())):
        (out / f'qmm_{name}.cu').write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *flags, '-I', str(_build.CSRC), '-o',
             str(out / f'libqmm_{name}.so'), str(out / f'qmm_{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(log)
    return {name: ctypes.CDLL(str(out / f'libqmm_{name}.so'))
            for name in procs}


def device_us(fn, iters=20):
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
                and 'qmm_wgmma_kernel' in e.key)
    return total / iters


def plans(M, N, K):
    """qmm_plan's own plan and the plans around it: BN 64 and 128, clusters
    of 1-8, rings of 2 to 4 stages."""
    bm, bn0, st0, c0, _ = qm.qmm_plan(M, N, K)
    nk = -(-K // qm.QMM_BK)
    bns = sorted({bn0, 64, 128} if N > 64 else {bn0})
    for bn in bns:
        for c in (1, 2, 4, 8):
            if c > nk:
                continue
            picks = {2, 4, max(1, min(4, -(-nk // c)))}
            if (bn, c) == (bn0, c0):
                picks.add(st0)
            for stages in sorted(picks):
                yield (bm, bn, stages, c, qm.qmm_smem_bytes(bn, stages),
                       (bn, stages, c) == (bn0, st0, c0))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(f'card: {smi}')
    libs = build()
    fns = {}
    for name, lib in libs.items():
        fn = lib.quant_matmul_wgmma_launch
        fn.argtypes, fn.restype = qm._ARGTYPES_WGMMA, ctypes.c_int
        fns[name] = fn
    phased = libs['phased']
    occ = libs['wide'].quant_matmul_wgmma_max_clusters
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    phased.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device='cuda').manual_seed(0)
    for M, K, N in SHAPES:
        x = torch.randint(-128, 128, (M, K), generator=g, device='cuda',
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-128, 128, (N, K), generator=g, device='cuda',
                          dtype=torch.int32).to(torch.int8).t()
        sx = torch.rand(M, generator=g, device='cuda') * 1e-2
        sw = torch.rand(N, generator=g, device='cuda') * 1e-2
        want = qm.quant_matmul_plain(x, w, sx, sw, relu=True, out_scale=0.37)
        out = torch.empty_like(want)
        bound_us = (M * K + K * N + 8 * (M + N) + M * N) / 3.35e12 * 1e6
        print(f'(M,K,N)=({M},{K},{N}): byte bound {bound_us:.2f} us')
        for bm, bn, stages, c, smem, picked in plans(M, N, K):
            def call(fn=fns['wide']):
                rc = fn(x.data_ptr(), w.data_ptr(), sx.data_ptr(),
                        sw.data_ptr(), None, out.data_ptr(), M, N, K, 1, 1,
                        qm.recip32(0.37), 127.0, bm, bn, stages, c, smem,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f'launch failed: {rc}')
            out.zero_()
            call()
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, want))
            us = device_us(call)
            n_cl = ctypes.c_int(0)
            rc = occ(bn, c, smem, ctypes.byref(n_cl))
            call(fns['phased'])
            torch.cuda.synchronize()
            blocks = c * -(-N // bn) * -(-M // bm)
            buf = np.zeros(blocks * 8, np.uint64)
            if phased.read_stamps(buf.ctypes.data, blocks * 8):
                raise SystemExit('reading the stamps failed')
            cyc = np.diff(buf.reshape(blocks, 8)[:, :6].astype(np.int64),
                          axis=1).mean(axis=0)
            print(f'  BN={bn} stages={stages} C={c} smem={smem} '
                  f'blocks={blocks}{" (qmm_plan)" if picked else ""}: '
                  f'{us:.2f} us, exact={exact}, clusters at once '
                  f'{n_cl.value if rc == 0 else f"error {rc}"}; cycles '
                  + ', '.join(f'{p} {v:.0f}' for p, v in zip(PHASES, cyc)))


if __name__ == '__main__':
    main()
