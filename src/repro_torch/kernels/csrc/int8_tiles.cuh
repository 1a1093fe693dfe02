// Device code shared by the int8 kernels (quant_matmul.cu, lowrank_conv.cu,
// depthwise_conv.cu): the mma.sync s8 warp product, the staging of int8
// tiles into shared memory with K contiguous, and the fused epilogue.
//
// The epilogue is written in explicit _rn intrinsics so that nvcc cannot
// contract acc*scale + b into an FMA: every kernel then equals the eager
// PyTorch plain versions (kernels/ref.py) bit for bit.  Never build with
// --use_fast_math.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace int8_tiles {

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s[r][k] = src[r0 + r][k0 + k] for a row-major (rows, K) source, zero
// outside.  VEC: K % 16 == 0 and src 16-byte aligned, one int4 per chunk.
template <int ROWS, int BK, int LDS, int THREADS, bool VEC>
__device__ __forceinline__ void stage_rows(int8_t (*s)[LDS],
                                           const int8_t* __restrict__ src,
                                           int rows, int K, int r0, int k0) {
  if (VEC) {
    for (int c = threadIdx.x; c < ROWS * BK / 16; c += THREADS) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int m = r0 + r, k = k0 + kc;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < rows && k < K)
        v = *reinterpret_cast<const int4*>(src + (size_t)m * K + k);
      *reinterpret_cast<int4*>(&s[r][kc]) = v;
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int m = r0 + r, k = k0 + kk;
      s[r][kk] = (m < rows && k < K) ? src[(size_t)m * K + k] : int8_t(0);
    }
  }
}

// s[n][k] = src[k0 + k][n0 + n] for a row-major (K, cols) source,
// transposed while staging so that K is contiguous; zero outside.
// VEC: cols % 4 == 0 and src 4-byte aligned, one word of 4 columns.
template <int COLS, int BK, int LDS, int THREADS, bool VEC>
__device__ __forceinline__ void stage_cols(int8_t (*s)[LDS],
                                           const int8_t* __restrict__ src,
                                           int cols, int K, int n0, int k0) {
  if (VEC) {
    for (int c = threadIdx.x; c < BK * COLS / 4; c += THREADS) {
      const int kk = c / (COLS / 4), n4 = (c % (COLS / 4)) * 4;
      const int k = k0 + kk, n = n0 + n4;
      uint32_t v = 0;
      if (k < K && n < cols)
        v = *reinterpret_cast<const uint32_t*>(src + (size_t)k * cols + n);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[n4 + j][kk] = static_cast<int8_t>((v >> (8 * j)) & 0xff);
    }
  } else {
    for (int c = threadIdx.x; c < BK * COLS; c += THREADS) {
      const int kk = c / COLS, nn = c % COLS;
      const int k = k0 + kk, n = n0 + nn;
      s[nn][kk] = (k < K && n < cols) ? src[(size_t)k * cols + n] : int8_t(0);
    }
  }
}

// One 32-deep step of a warp's (MI*16) x (NJ*8) tile: A row-major from
// as[row][k], B from bs[col][k] (both K contiguous), at rows wm.., columns
// wn.., depth kk..kk+31.
template <int MI, int NJ, int LDA, int LDB>
__device__ __forceinline__ void warp_mma_k32(int (&acc)[MI][NJ][4],
                                             int8_t (*as)[LDA],
                                             int8_t (*bs)[LDB], int wm,
                                             int wn, int kk, int lane) {
  const int g = lane / 4, t = lane % 4;
  uint32_t a[MI][4], b[NJ][2];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = wm + i * 16 + g;
    a[i][0] = *reinterpret_cast<const uint32_t*>(&as[r][kk + t * 4]);
    a[i][1] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + t * 4]);
    a[i][2] = *reinterpret_cast<const uint32_t*>(&as[r][kk + 16 + t * 4]);
    a[i][3] = *reinterpret_cast<const uint32_t*>(&as[r + 8][kk + 16 + t * 4]);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = wn + j * 8 + g;
    b[j][0] = *reinterpret_cast<const uint32_t*>(&bs[n][kk + t * 4]);
    b[j][1] = *reinterpret_cast<const uint32_t*>(&bs[n][kk + 16 + t * 4]);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], a[i], b[j]);
}

// Accumulator (i, j, r) of a warp tile sits at row wm + i*16 + g (+8 for
// r >= 2) and column wn + j*8 + 2t + (r & 1).
__device__ __forceinline__ int frag_row(int wm, int i, int r, int lane) {
  return wm + i * 16 + lane / 4 + (r >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int wn, int j, int r, int lane) {
  return wn + j * 8 + (lane % 4) * 2 + (r & 1);
}

// y = float(acc) * scale (+ bias[n]) (ReLU), the plain versions' op order.
__device__ __forceinline__ float dequant(int acc, float scale,
                                         const float* __restrict__ bias,
                                         int n, int relu) {
  float y = __fmul_rn(static_cast<float>(acc), scale);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (relu) y = fmaxf(y, 0.0f);
  return y;
}

// The same with the bias already loaded (b, used when has_bias).
__device__ __forceinline__ float dequant(int acc, float scale, bool has_bias,
                                         float b, int relu) {
  float y = __fmul_rn(static_cast<float>(acc), scale);
  if (has_bias) y = __fadd_rn(y, b);
  if (relu) y = fmaxf(y, 0.0f);
  return y;
}

// Static requantize: rint(y * inv_scale) (half to even), clipped to int8.
__device__ __forceinline__ int8_t requant(float y, float inv_scale,
                                          float qmax) {
  float q = rintf(__fmul_rn(y, inv_scale));
  q = fminf(fmaxf(q, -qmax - 1.0f), qmax);
  return static_cast<int8_t>(q);
}

}  // namespace int8_tiles

// Each kernel library is a shared object of its own and defines this once.
extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
