// Fused low-rank conv for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel in src/repro/kernels/lowrank_conv.py
// (`lowrank_conv` / `_lr_kernel`): a factored conv pair (u: KHxKWxCIN ->
// R, v: 1x1 R -> COUT) in one launch, on the im2col patches (M, K1):
//     h   = requant(float(patches @ u) * (sx * su[r]) + bu[r], h_scale)
//     out = float(h @ v) * (h_scale * sv[n]) + bv[n]  (ReLU) (requantize)
// with the epilogues of int8_tiles.cuh, so the launch equals the chained
// pair of quant_matmul launches (u with out_scale = h_scale, then v) bit
// for bit.  The rank must fit one 128-wide tile (R <= 128, the fused
// envelope of kernels/lowrank_conv.py `fits_fused`).
//
// What bounds it on an H100.  The patches are read once, the output
// written once, and h (M x R int8) never touches device memory.  With
// K1 <= 2304 and R <= 128 the int8 work is at most 2*M*128*(K1 + COUT)
// operations against M*K1 + M*COUT bytes, below the card's 590
// operations-per-byte line at 1979 TOP/s and 3.35 TB/s: bound by bytes.
//
// Design.  The TPU kernel carries its accumulator and h in scratch across
// a sequential (M, K1, N) grid.  Blocks on Hopper run in no order and
// share nothing, so here one block owns a BM-row tile of M and does the
// whole pair for it:
//   1. patches[BM, K1] @ u[K1, 128] with mma.sync.m16n8k32 s8 (the tiles
//      of quant_matmul.cu, K1 in 64-byte steps; u's 64 rows of a step are
//      one contiguous run of 64*R bytes, read with 16-byte loads and
//      transposed in shared memory; rank columns >= R are zeros, and a
//      warp whose columns all lie there skips its products);
//   2. the u epilogue requantizes h to int8 into shared memory (BM x 144
//      bytes), columns >= R set to 0;
//   3. a loop over every 64-wide COUT tile stages v's tile and computes
//      h @ v over ceil(R / 32) depth steps, then the v epilogue writes the
//      output once.
// Ragged M, K1, R and COUT are masked while staging; nothing is padded in
// device memory.  BM is 64 (2x2 warps) or 32 (1x4 warps, twice the blocks
// for the small-M layers); the wrapper picks it from M (lowrank_conv.py
// `pick_bm`, measured on an H100).
#include "int8_tiles.cuh"

namespace {

using namespace int8_tiles;

constexpr int RP = 128;          // rank tile: the fused envelope
constexpr int BK = 64;           // K1 step of the u stage
constexpr int BN = 64;           // COUT tile of the v stage
constexpr int LDS = BK + 16;     // smem row stride of the u-stage tiles
constexpr int LDH = RP + 16;     // smem row stride of h and the v tile
constexpr int THREADS = 128;

// us[r][kk] = u[k0 + kk][r] for r < R, zero for rows k0 + kk >= K1.  Rows
// k0..k0+BK-1 of the row-major (K1, R) u are one contiguous run of BK*R
// bytes, 16-byte aligned when u is (k0 is a multiple of 64): it is read
// with 16-byte loads and transposed byte by byte into shared memory, so a
// rank that is not a multiple of 4 costs no byte-wise global loads.
// Columns r >= R are never written here (the caller zeroes them once).
__device__ __forceinline__ void stage_u(int8_t (*us)[LDS],
                                        const int8_t* __restrict__ u, int R,
                                        int K1, int k0) {
  const int rows = min(BK, K1 - k0);
  const int nbytes = rows * R;
  const int8_t* src = u + (size_t)k0 * R;
  const int nvec = nbytes / 16;
  for (int c = threadIdx.x; c < nvec; c += THREADS) {
    const int4 v = reinterpret_cast<const int4*>(src)[c];
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    int kk = (c * 16) / R, r = c * 16 - kk * R;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      us[r][kk] = b[j];
      if (++r == R) {
        r = 0;
        ++kk;
      }
    }
  }
  for (int i = nvec * 16 + threadIdx.x; i < nbytes; i += THREADS) {
    const int kk = i / R;
    us[i - kk * R][kk] = src[i];
  }
  for (int i = threadIdx.x; i < (BK - rows) * R; i += THREADS) {
    const int kk = rows + i / R;
    us[i % R][kk] = 0;
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
lr_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ u,
          const int8_t* __restrict__ v, const float* __restrict__ su,
          const float* __restrict__ bu, const float* __restrict__ sv,
          const float* __restrict__ bv, void* __restrict__ out, int M,
          int K1, int R, int N, float sx, float h_scale, float inv_h_scale,
          float h_qmax, int relu, int out_int8, float inv_out_scale,
          float out_qmax, int vec_x, int vec_u, int vec_v) {
  constexpr int WARPS_M = BM / 32;
  constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
  constexpr int NJ1 = RP / WARPS_N / 8;     // u stage: 8-wide column frags
  constexpr int NJ2 = BN / WARPS_N / 8;     // v stage
  __shared__ __align__(16) int8_t xs[BM][LDS];
  __shared__ __align__(16) int8_t us[RP][LDS];
  __shared__ __align__(16) int8_t hs[BM][LDH];
  __shared__ __align__(16) int8_t vs[BN][LDH];

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * 32;
  const int wn1 = (warp % WARPS_N) * (RP / WARPS_N);
  const int wn2 = (warp % WARPS_N) * (BN / WARPS_N);

  // 1. u stage: acc = patches[m0:m0+BM, :] @ u.  The rank columns >= R
  // of the u tile stay zero, and a warp whose columns all lie there skips
  // its products.
  if (vec_u)
    for (int i = threadIdx.x; i < (RP - R) * BK; i += THREADS)
      us[R + i / BK][i % BK] = 0;
  int acc[2][NJ1][4] = {};
  for (int k0 = 0; k0 < K1; k0 += BK) {
    if (vec_x)
      stage_rows<BM, BK, LDS, THREADS, true>(xs, x, M, K1, m0, k0);
    else
      stage_rows<BM, BK, LDS, THREADS, false>(xs, x, M, K1, m0, k0);
    if (vec_u)
      stage_u(us, u, R, K1, k0);
    else
      stage_cols<RP, BK, LDS, THREADS, false>(us, u, R, K1, 0, k0);
    __syncthreads();
    if (wn1 < R) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32)
        warp_mma_k32<2, NJ1, LDS, LDS>(acc, xs, us, wm, wn1, kk, lane);
    }
    __syncthreads();
  }

  // 2. u epilogue: h stays in shared memory as int8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ1; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = frag_row(wm, i, r, lane);
        const int col = frag_col(wn1, j, r, lane);
        int8_t h = 0;
        if (col < R)
          h = requant(dequant(acc[i][j][r], __fmul_rn(sx, su[col]), bu, col,
                              0),
                      inv_h_scale, h_qmax);
        hs[row][col] = h;
      }

  // 3. v stage, one COUT tile at a time; the output is written once
  const int rk = (R + 31) / 32 * 32;
  for (int n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();               // h written, previous v tile consumed
    if (vec_v)
      stage_cols<BN, RP, LDH, THREADS, true>(vs, v, N, R, n0, 0);
    else
      stage_cols<BN, RP, LDH, THREADS, false>(vs, v, N, R, n0, 0);
    __syncthreads();
    int acc2[2][NJ2][4] = {};
    for (int kk = 0; kk < rk; kk += 32)
      warp_mma_k32<2, NJ2, LDH, LDH>(acc2, hs, vs, wm, wn2, kk, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = m0 + frag_row(wm, i, r, lane);
          const int n = n0 + frag_col(wn2, j, r, lane);
          if (m >= M || n >= N) continue;
          const float y = dequant(acc2[i][j][r], __fmul_rn(h_scale, sv[n]),
                                  bv, n, relu);
          const size_t o = (size_t)m * N + n;
          if (out_int8)
            static_cast<int8_t*>(out)[o] =
                requant(y, inv_out_scale, out_qmax);
          else
            static_cast<float*>(out)[o] = y;
        }
  }
}

}  // namespace

extern "C" int lowrank_conv_launch(
    const void* x, const void* u, const void* v, const void* su,
    const void* bu, const void* sv, const void* bv, void* out, int M, int K1,
    int R, int N, float sx, float h_scale, float inv_h_scale, float h_qmax,
    int relu, int out_int8, float inv_out_scale, float out_qmax, int vec_x,
    int vec_u, int vec_v, int bm, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto up = static_cast<const int8_t*>(u);
  auto vp = static_cast<const int8_t*>(v);
  auto sup = static_cast<const float*>(su);
  auto bup = static_cast<const float*>(bu);
  auto svp = static_cast<const float*>(sv);
  auto bvp = static_cast<const float*>(bv);
  if (R < 1 || R > RP || (bm != 32 && bm != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 32)
    lr_kernel<32><<<(M + 31) / 32, THREADS, 0, st>>>(
        xp, up, vp, sup, bup, svp, bvp, out, M, K1, R, N, sx, h_scale,
        inv_h_scale, h_qmax, relu, out_int8, inv_out_scale, out_qmax, vec_x,
        vec_u, vec_v);
  else
    lr_kernel<64><<<(M + 63) / 64, THREADS, 0, st>>>(
        xp, up, vp, sup, bup, svp, bvp, out, M, K1, R, N, sx, h_scale,
        inv_h_scale, h_qmax, relu, out_int8, inv_out_scale, out_qmax, vec_x,
        vec_u, vec_v);
  return static_cast<int>(cudaGetLastError());
}
