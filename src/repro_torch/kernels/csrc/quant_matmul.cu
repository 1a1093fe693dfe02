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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;   // smem row stride in bytes
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// xs[r][k] = x[m0 + r][k0 + k], zero outside (M, K).
template <bool VEC>
__device__ __forceinline__ void stage_x(int8_t (*xs)[LDS],
                                        const int8_t* __restrict__ x, int M,
                                        int K, int m0, int k0) {
  if (VEC) {  // K % 16 == 0 and x 16-byte aligned: one int4 per chunk
    for (int c = threadIdx.x; c < BM * BK / 16; c += THREADS) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int m = m0 + r, k = k0 + kc;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M && k < K)
        v = *reinterpret_cast<const int4*>(x + (size_t)m * K + k);
      *reinterpret_cast<int4*>(&xs[r][kc]) = v;
    }
  } else {
    for (int c = threadIdx.x; c < BM * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int m = m0 + r, k = k0 + kk;
      xs[r][kk] = (m < M && k < K) ? x[(size_t)m * K + k] : int8_t(0);
    }
  }
}

// ws[n][k] = w[k0 + k][n0 + n] (transposed: K contiguous), zero outside.
template <bool VEC>
__device__ __forceinline__ void stage_w(int8_t (*ws)[LDS],
                                        const int8_t* __restrict__ w, int N,
                                        int K, int n0, int k0) {
  if (VEC) {  // N % 4 == 0 and w 4-byte aligned: one word of 4 columns
    for (int c = threadIdx.x; c < BK * BN / 4; c += THREADS) {
      const int kk = c / (BN / 4), n4 = (c % (BN / 4)) * 4;
      const int k = k0 + kk, n = n0 + n4;
      uint32_t v = 0;
      if (k < K && n < N)
        v = *reinterpret_cast<const uint32_t*>(w + (size_t)k * N + n);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ws[n4 + j][kk] = static_cast<int8_t>((v >> (8 * j)) & 0xff);
    }
  } else {
    for (int c = threadIdx.x; c < BK * BN; c += THREADS) {
      const int kk = c / BN, nn = c % BN;
      const int k = k0 + kk, n = n0 + nn;
      ws[nn][kk] = (k < K && n < N) ? w[(size_t)k * N + n] : int8_t(0);
    }
  }
}

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
  const int g = lane / 4, t = lane % 4;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_x<VEC_X>(xs, x, M, K, m0, k0);
    stage_w<VEC_W>(ws, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + t * 4]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + t * 4]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 16 + t * 4]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + t * 4]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // Epilogue: accumulator (i, j, r) sits at row g (+8 for r >= 2) and
  // column 2t + (r & 1) of the warp's 16x8 sub-tile (i, j).
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (m >= M || n >= N) continue;
        const float scale = __fmul_rn(sx[m], sw[n]);
        float y = __fmul_rn(static_cast<float>(acc[i][j][r]), scale);
        if (bias != nullptr) y = __fadd_rn(y, bias[n]);
        if (relu) y = fmaxf(y, 0.0f);
        const size_t o = (size_t)m * N + n;
        if (out_int8) {
          float q = rintf(__fmul_rn(y, inv_out_scale));
          q = fminf(fmaxf(q, -out_qmax - 1.0f), out_qmax);
          static_cast<int8_t*>(out)[o] = static_cast<int8_t>(q);
        } else {
          static_cast<float*>(out)[o] = y;
        }
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

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
