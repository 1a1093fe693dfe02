#!/usr/bin/env python3
"""The fake-quant cluster kernel across launch plans at path (f)'s shapes,
and a two-pass design whose second read of w comes from L2.

For tinyllama-1.1b's MLP ``wo`` (5632, 2048), which the Q pass sends to the
two-pass ``fake_quant`` wrapper, and its (2048, 5632) ``wi`` on the fused
wrapper, this script launches ``fq_cluster_kernel`` through its C entry
point with every staged plan (BN 16-128 columns a stripe, clusters of 1-16
blocks along K, 16 a non-portable size) whose slice fits a block's shared
memory, checks each output bit for bit against the plain version, and
prints each plan's device time under torch.profiler beside the byte bound
(w read once, the output written once, at 3.35 TB/s), marking the plan
``fused_plan`` picks (both wrappers launch the kernel on it).

Then the alternative the library does not build (``L2_SOURCE``, compiled
here under ``build/``): an abs-max pass that writes each (256, 64-column)
tile's column maxima to a buffer (no zero fill, no atomics), and a
quantize pass that reduces a column's tile maxima and walks the tiles in
the reverse order, so that its read of w finds the tiles the first pass
read last still in the 50 MB L2; timed as the pair, bit-exact too.  No
path runs that design: it lost to the one-read cluster kernel on the
H100, and it stays here so that the measurement which rejected it
(PERF.md, Findings) can be taken again.
Prints the card's name and power limit.  Needs one card and nvcc:

    python3 scripts/fq_plan_sweep.py
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'src'))

from repro_torch.kernels import fake_quant as fq  # noqa: E402
from repro_torch.kernels.ref import recip32  # noqa: E402
from repro_torch.kernels.tiling import SMEM_BUDGET  # noqa: E402

SHAPES = (((5632, 2048), torch.bfloat16), ((5632, 2048), torch.float32),
          ((2048, 5632), torch.bfloat16))
CLUSTERS = (1, 2, 4, 8, 16)
L2_BK = 256           # rows of a tile of the L2 two-pass design
L2_SOURCE = r'''
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(x);
}

// 128-byte tile rows: V elements a thread, CPR threads a row
template <typename T>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int BN = 128 / sizeof(T);
  static constexpr int CPR = BN / V;
  static constexpr int RSTEP = THREADS / CPR;
};

// part[tile_row][n] = max |w| over rows [BK * tile_row, +BK) of column n
template <typename T>
__global__ void __launch_bounds__(THREADS)
amax_tiles(const T* __restrict__ w, float* __restrict__ part, int K, int N) {
  using L = Tile<T>;
  __shared__ float red[L::RSTEP][L::BN];
  const int t = threadIdx.x, cv = t % L::CPR, r0 = t / L::CPR;
  const int col = blockIdx.x * L::BN + cv * L::V;
  const int k0 = blockIdx.y * BK;
  float mx[L::V] = {};
  if (col < N) {
    for (int r = k0 + r0; r < min(k0 + BK, K); r += L::RSTEP) {
      const uint4 u = *reinterpret_cast<const uint4*>(w + (size_t)r * N + col);
      const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < L::V; ++i) mx[i] = fmaxf(mx[i], fabsf(to_f32(x[i])));
    }
  }
#pragma unroll
  for (int i = 0; i < L::V; ++i) red[r0][cv * L::V + i] = mx[i];
  __syncthreads();
  if (t < L::BN && blockIdx.x * L::BN + t < N) {
    float a = 0.0f;
    for (int q = 0; q < L::RSTEP; ++q) a = fmaxf(a, red[q][t]);
    part[(size_t)blockIdx.y * N + blockIdx.x * L::BN + t] = a;
  }
}

// the same tiles in the reverse order: scales from the tile maxima, then
// the quantize of this tile
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_tiles(const T* __restrict__ w, const float* __restrict__ part,
            T* __restrict__ out, int K, int N, float qmax, float inv_qmax) {
  using L = Tile<T>;
  __shared__ float scale[L::BN];
  const int bx = gridDim.x - 1 - blockIdx.x, by = gridDim.y - 1 - blockIdx.y;
  const int t = threadIdx.x, cv = t % L::CPR, r0 = t / L::CPR;
  if (t < L::BN) {
    float a = 0.0f;
    const int n = bx * L::BN + t;
    if (n < N)
      for (int q = 0; q < gridDim.y; ++q)
        a = fmaxf(a, part[(size_t)q * N + n]);
    scale[t] = __fmul_rn(fmaxf(a, 1e-8f), inv_qmax);
  }
  __syncthreads();
  const int col = bx * L::BN + cv * L::V;
  if (col >= N) return;
  float sc[L::V];
#pragma unroll
  for (int i = 0; i < L::V; ++i) sc[i] = scale[cv * L::V + i];
  const int k0 = by * BK;
  for (int r = k0 + r0; r < min(k0 + BK, K); r += L::RSTEP) {
    const size_t o = (size_t)r * N + col;
    const uint4 u = *reinterpret_cast<const uint4*>(w + o);
    const T* x = reinterpret_cast<const T*>(&u);
    uint4 v;
    T* y = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < L::V; ++i) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[i]), sc[i])),
                                  -qmax - 1.0f), qmax);
      from_f32(__fmul_rn(q, sc[i]), y + i);
    }
    *reinterpret_cast<uint4*>(out + o) = v;
  }
}

template <typename T>
int run(const void* w, float* part, void* out, int K, int N, float qmax,
        float inv_qmax, cudaStream_t st) {
  const dim3 grid((N + Tile<T>::BN - 1) / Tile<T>::BN, (K + BK - 1) / BK);
  amax_tiles<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(w), part, K,
                                          N);
  quant_tiles<T><<<grid, THREADS, 0, st>>>(static_cast<const T*>(w), part,
                                           static_cast<T*>(out), K, N, qmax,
                                           inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, out (K, N) with N * sizeof(T) % 16 == 0 and 16-byte aligned rows;
// part: ceil(K / 256) * N floats
extern "C" int fq_l2_two_pass(const void* w, void* part, void* out, int K,
                              int N, int bf16, float qmax, float inv_qmax,
                              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
  return bf16 ? run<__nv_bfloat16>(w, p, out, K, N, qmax, inv_qmax, st)
              : run<float>(w, p, out, K, N, qmax, inv_qmax, st);
}
'''


def build_l2():
    """The L2 two-pass pair, compiled beside the kernels under build/."""
    import ctypes
    from repro_torch.kernels import _build
    out = _build.BUILD_ROOT / 'fq_sweep'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'fq_l2.cu').write_text(L2_SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
    r = subprocess.run([_build.nvcc(), *flags, '-o', str(out / 'libfq_l2.so'),
                        str(out / 'fq_l2.cu')], capture_output=True,
                       text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    fn = ctypes.CDLL(str(out / 'libfq_l2.so')).fq_l2_two_pass
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def device_us(fn, names=('fq_cluster_kernel',), iters=50):
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
                and any(n in e.key for n in names))
    return total / iters


def same_bits(a, b):
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(view), b.view(view)))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    launch = fq._fused_launcher()
    l2 = build_l2()
    g = torch.Generator(device='cuda').manual_seed(0)
    bits, qmax = 8, 127.0
    for (K, N), dtype in SHAPES:
        w = torch.randn((K, N), generator=g, device='cuda').to(dtype)
        want = fq.fake_quant_plain(w, bits=bits)
        out = torch.empty_like(w)
        eb = w.element_size()
        bound_us = 2 * K * N * eb / 3.35e12 * 1e6
        pick = fq.fused_plan(K, N, eb)[:2]
        print(f'(K,N)=({K},{N}) {str(dtype)[6:]}: byte bound '
              f'{bound_us:.2f} us; fused_plan picks BN={pick[0]} '
              f'C={pick[1]}')
        for bn in fq.FUSED_BNS:
            for c in CLUSTERS:
                r = -(-K // c)
                smem = 8 * bn + r * bn * eb
                if smem > SMEM_BUDGET:
                    continue

                def call(bn=bn, c=c, r=r, smem=smem):
                    rc = launch(w.data_ptr(), out.data_ptr(), K, N, bn, c, r,
                                smem, 1, 1, int(dtype == torch.bfloat16),
                                qmax, recip32(qmax),
                                torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise SystemExit(f'launch failed: {rc}')
                out.zero_()
                call()
                torch.cuda.synchronize()
                exact = same_bits(out, want)
                us = device_us(call)
                marks = ' (fused_plan)' if pick == (bn, c) else ''
                print(f'  BN={bn} C={c} R={r} smem={smem} '
                      f'blocks={-(-N // bn) * c}{marks}: {us:.2f} us '
                      f'({bound_us / us:.0%} of the bound), exact={exact}')
        part = torch.empty((-(-K // L2_BK), N), device='cuda')

        def pair():
            rc = l2(w.data_ptr(), part.data_ptr(), out.data_ptr(), K, N,
                    int(dtype == torch.bfloat16), qmax, recip32(qmax),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f'launch failed: {rc}')
        out.zero_()
        pair()
        torch.cuda.synchronize()
        exact = same_bits(out, want)
        us = device_us(pair, ('amax_tiles', 'quant_tiles'))
        amax_us = device_us(pair, ('amax_tiles',))
        print(f'  L2 two-pass, {-(-K // L2_BK)} x {-(-N // (128 // eb))} '
              f'tiles of ({L2_BK}, {128 // eb}): {us:.2f} us the pair '
              f'({amax_us:.2f} the abs-max pass; {bound_us / us:.0%} of the '
              f'bound), exact={exact}')


if __name__ == '__main__':
    main()
