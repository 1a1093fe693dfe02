// W8A8 quantized matmul for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel in src/repro/kernels/quant_matmul.py
// (`quant_matmul` / `_qmm_kernel`): int8 x (M,K) @ int8 w (K,N) into an
// int32 accumulator, then the fused epilogue
//     y = float(acc) * (sx[m] * sw[n])  (+ bias[n])  (ReLU)
//     int8 out: clip(rint(y * inv_out_scale), -qmax-1, qmax)
// The reference runs its epilogue under jit, where XLA turns the division
// by the static out_scale into a multiply by its fp32 reciprocal; the
// wrapper passes that reciprocal, so the int8 codes match the reference.
// Every epilogue op is an explicit _rn intrinsic: nvcc may not contract
// acc*scale + b into an FMA, so the result equals the eager PyTorch
// version (kernels/ref.py) bit for bit.  Never build with --use_fast_math.
//
// What bounds it on an H100.  Every call on the serving path is an im2col
// conv or a head: K <= 4608 and N <= 512, so the int8 tensor-core work
// (2*M*N*K ops at 1979 TOP/s) is smaller than the bytes moved (patches,
// weights and the output at 3.35 TB/s): the calls are bound by bytes.
//
// Design.  One 64x64 output tile per block of 4 warps (2x2, 32x32 each);
// K advances in 64-byte steps.  x and w tiles are staged in shared memory
// with K contiguous (w is transposed while staging), rows padded to 80
// bytes so the fragment loads are free of bank conflicts, and fed to
// mma.sync.m16n8k32 s8 with int32 accumulation.  Ragged M, N and K edges
// are masked with zeros (zero codes add nothing to the accumulator), so
// there is no padding of the operands in device memory; K = 27 (the stem)
// takes the byte-wise staging path.  Left for later: a TMA + wgmma
// pipeline with several stages in flight, and an implicit-GEMM im2col
// that gathers the patches inside the kernel instead of in device memory.
// The staging, the warp product and the epilogue live in int8_tiles.cuh,
// shared with the fused low-rank kernel.
#include "int8_tiles.cuh"

namespace {

using namespace int8_tiles;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;   // smem row stride in bytes
constexpr int THREADS = 128;

template <bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ sx, const float* __restrict__ sw,
           const float* __restrict__ bias, void* __restrict__ out, int M,
           int N, int K, int relu, int out_int8, float inv_out_scale,
           float out_qmax) {
  __shared__ __align__(16) int8_t xs[BM][LDS];
  __shared__ __align__(16) int8_t ws[BN][LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_rows<BM, BK, LDS, THREADS, VEC_X>(xs, x, M, K, m0, k0);
    stage_cols<BN, BK, LDS, THREADS, VEC_W>(ws, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32)
      warp_mma_k32<2, 4, LDS, LDS>(acc, xs, ws, wm, wn, kk, lane);
    __syncthreads();
  }

  // Epilogue, one accumulator at a time (frag_row / frag_col).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + frag_row(wm, i, r, lane);
        const int n = n0 + frag_col(wn, j, r, lane);
        if (m >= M || n >= N) continue;
        const float y = dequant(acc[i][j][r], __fmul_rn(sx[m], sw[n]), bias,
                                n, relu);
        const size_t o = (size_t)m * N + n;
        if (out_int8)
          static_cast<int8_t*>(out)[o] = requant(y, inv_out_scale, out_qmax);
        else
          static_cast<float*>(out)[o] = y;
      }
}

template <bool VEC_X, bool VEC_W>
void launch(const int8_t* x, const int8_t* w, const float* sx,
            const float* sw, const float* bias, void* out, int M, int N,
            int K, int relu, int out_int8, float inv_out_scale,
            float out_qmax, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<VEC_X, VEC_W><<<grid, THREADS, 0, stream>>>(
      x, w, sx, sw, bias, out, M, N, K, relu, out_int8, inv_out_scale,
      out_qmax);
}

}  // namespace

extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* sx, const void* sw,
                                   const void* bias, void* out, int M, int N,
                                   int K, int relu, int out_int8,
                                   float inv_out_scale, float out_qmax,
                                   int vec_x, int vec_w, void* stream) {
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sxp = static_cast<const float*>(sx);
  auto swp = static_cast<const float*>(sw);
  auto bp = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec_x && vec_w)
    launch<true, true>(xp, wp, sxp, swp, bp, out, M, N, K, relu, out_int8,
                       inv_out_scale, out_qmax, st);
  else if (vec_x)
    launch<true, false>(xp, wp, sxp, swp, bp, out, M, N, K, relu, out_int8,
                        inv_out_scale, out_qmax, st);
  else if (vec_w)
    launch<false, true>(xp, wp, sxp, swp, bp, out, M, N, K, relu, out_int8,
                        inv_out_scale, out_qmax, st);
  else
    launch<false, false>(xp, wp, sxp, swp, bp, out, M, N, K, relu, out_int8,
                         inv_out_scale, out_qmax, st);
  return static_cast<int>(cudaGetLastError());
}
