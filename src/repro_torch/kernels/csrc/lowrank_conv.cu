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
// envelope of kernels/lowrank_conv.py `fits_fused`).  Both factors are
// read K-major, as core/export.py stores them: u[k][r] at u + r * K1 + k,
// v[r][n] at v + n * R + r (the s8 tensor-core operands are K-major).
//
// What bounds it on an H100.  The patches are read once, the output
// written once, and h (M x R int8) never touches device memory.  With
// K1 <= 2304 and R <= 128 the int8 work is at most 2*M*128*(K1 + COUT)
// operations against M*K1 + M*COUT bytes, below the card's 590
// operations-per-byte line at 1979 TOP/s and 3.35 TB/s: bound by bytes.
// The layers are small (resnet34-cifar's stage 2 at 32 slots has 16
// tiles of 128 rows and 18 K1 tiles), so the design is about keeping
// enough blocks busy and the loads of a block in flight.
//
// lr_wgmma_kernel (K1 % 16 == 0, 16-byte aligned patches, u and v: every
// main-path layer).  A block of two consumer warpgroups and one producer
// warp owns a 128-row tile of M; the launch plan (kernels/lowrank_conv.py
// `lr_plan`) gives RP (the rank rounded up to 32, 64, 96 or 128), VN (the
// v stage's 32 or 64 output columns), the ring's stages and C.
//   1. u stage: the producer keeps a ring of 128-byte K1 tiles of the
//      patches and of u's RP rows in flight with TMA (128-byte swizzle;
//      the ragged M and K1 edges and u's rows at R and above zero-filled
//      by the hardware); each consumer warpgroup runs
//      wgmma.m64nRPk32.s32.s8.s8 on its 64 rows.  Where the M tiles are
//      too few to fill the card, a thread-block cluster of C blocks
//      shares one M tile and splits its K1 tiles evenly; each block
//      writes its int32 partial h tile over the drained ring.
//   2. h: unsplit, each consumer thread requantizes its own accumulators;
//      split, after a cluster barrier rank r sums rows [r*128/C,
//      (r+1)*128/C) of the C partials over distributed shared memory
//      (integer sums are exact in any order: every split gives the same
//      bits), requantizes them and stores the int8 rows into every
//      block's h tile.  h lies in shared memory in the swizzled K-major
//      layout wgmma reads, columns at R and above 0.
//   3. v stage: each rank takes an even share of the VN-wide COUT tiles;
//      v's rows for a tile are one contiguous run of VN * R bytes, copied
//      with 16-byte cp.async (R is rarely a multiple of 16, so TMA cannot
//      take them) into a linear buffer, the first two tiles while the u
//      stage runs, then laid into a swizzled tile; wgmma.m64nVNk32 over
//      RP / 32 steps, and the epilogue writes the output once.
// The epilogue's scales are loaded before the main loop.  The plan keeps
// two blocks on an SM (shared memory and, by the launch bounds,
// registers), so a split grid runs in one wave; the launcher refuses a
// plan whose shared memory is smaller than the layout.
//
// lr_kernel (the rest: K1 % 16 != 0 or a misaligned operand).  One block
// of 4 warps owns a 32-row tile of M and does the whole pair with
// mma.sync.m16n8k32 s8: K1 in 64-byte steps staged in shared memory, h
// requantized into shared memory, then every 64-wide COUT tile.  Both
// factors are read K-major, as rows.  Ragged edges are masked while
// staging; nothing is padded in device memory.
#include <cooperative_groups.h>
#include <cuda.h>

#include "int8_tiles.cuh"
#include "wgmma_tma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace int8_tiles;
using namespace wgmma_tma;

// ---------------------------------------------------------------------
// lr_kernel: mma.sync, any K1.

constexpr int RP = 128;          // rank tile: the fused envelope
constexpr int BM = 32;           // M tile (1 x 4 warps)
constexpr int BK = 64;           // K1 step of the u stage
constexpr int BN = 64;           // COUT tile of the v stage
constexpr int LDS = BK + 16;     // smem row stride of the u-stage tiles
constexpr int LDH = RP + 16;     // smem row stride of h and the v tile
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
lr_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ u,
          const int8_t* __restrict__ v, const float* __restrict__ su,
          const float* __restrict__ bu, const float* __restrict__ sv,
          const float* __restrict__ bv, void* __restrict__ out, int M,
          int K1, int R, int N, float sx, float h_scale, float inv_h_scale,
          float h_qmax, int relu, int out_int8, float inv_out_scale,
          float out_qmax, int vec_x, int vec_u, int vec_v) {
  constexpr int WARPS_N = THREADS / 32;
  constexpr int NJ1 = RP / WARPS_N / 8;     // u stage: 8-wide column frags
  constexpr int NJ2 = BN / WARPS_N / 8;     // v stage
  __shared__ __align__(16) int8_t xs[BM][LDS];
  __shared__ __align__(16) int8_t us[RP][LDS];
  __shared__ __align__(16) int8_t hs[BM][LDH];
  __shared__ __align__(16) int8_t vs[BN][LDH];

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn1 = warp * (RP / WARPS_N);
  const int wn2 = warp * (BN / WARPS_N);

  // 1. u stage: acc = patches[m0:m0+BM, :] @ u.  u's rows are staged as
  // the tile's columns; rows >= R are zeros, and a warp whose columns all
  // lie there skips its products.
  int acc[2][NJ1][4] = {};
  for (int k0 = 0; k0 < K1; k0 += BK) {
    if (vec_x)
      stage_rows<BM, BK, LDS, THREADS, true>(xs, x, M, K1, m0, k0);
    else
      stage_rows<BM, BK, LDS, THREADS, false>(xs, x, M, K1, m0, k0);
    if (vec_u)
      stage_rows<RP, BK, LDS, THREADS, true>(us, u, R, K1, 0, k0);
    else
      stage_rows<RP, BK, LDS, THREADS, false>(us, u, R, K1, 0, k0);
    __syncthreads();
    if (wn1 < R) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32)
        warp_mma_k32<2, NJ1, LDS, LDS>(acc, xs, us, 0, wn1, kk, lane);
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
        const int row = frag_row(0, i, r, lane);
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
      stage_rows<BN, RP, LDH, THREADS, true>(vs, v, N, R, n0, 0);
    else
      stage_rows<BN, RP, LDH, THREADS, false>(vs, v, N, R, n0, 0);
    __syncthreads();
    int acc2[2][NJ2][4] = {};
    for (int kk = 0; kk < rk; kk += 32)
      warp_mma_k32<2, NJ2, LDH, LDH>(acc2, hs, vs, 0, wn2, kk, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = m0 + frag_row(0, i, r, lane);
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

// ---------------------------------------------------------------------
// lr_wgmma_kernel: TMA + wgmma, K1 split over a cluster.

constexpr int LW_BM = 128;                 // two consumer warpgroups
constexpr int LW_BK = TMA_BOX_K;           // bytes of K1 a stage
constexpr int LW_CONSUMERS = 2;
constexpr int LW_THREADS = 128 * LW_CONSUMERS + 32;   // + a producer warp
constexpr int LW_PAD = 8;                  // int32 partial rows: RP + 8
constexpr int LW_MAX_CLUSTER = 8;          // lr_plan's largest cluster
constexpr int LW_MAX_STAGES = 4;           // and ring

// Bytes of one linear buffer of v rows: a VN-row tile of at most RP bytes
// a row, and the up to 15 bytes before it that its 16-byte copies start at.
__host__ __device__ constexpr size_t lw_vlin(int rp, int vn) {
  return static_cast<size_t>(vn) * rp + 32;
}

// The ring of stages (patches tile 128 x 128 bytes, u tile RP x 128) or,
// after the main loop of a split (C > 1), the int32 partial h tile
// [128][RP + 8] over it, rounded up to 1024 bytes.
__host__ __device__ constexpr size_t lw_main(int rp, int stages, int c) {
  return ((static_cast<size_t>(stages) * (LW_BM + rp) * LW_BK >
                   (c > 1 ? static_cast<size_t>(LW_BM) * (rp + LW_PAD) * 4
                          : 0)
               ? static_cast<size_t>(stages) * (LW_BM + rp) * LW_BK
               : static_cast<size_t>(LW_BM) * (rp + LW_PAD) * 4) +
          1023) /
         1024 * 1024;
}

// Shared memory of a block: 1024 bytes to align to the swizzle's atom,
// lw_main, the int8 h tile [128][128], the v tile [VN][128] (both
// swizzled), two linear v buffers, the scales (sx * su and bu over RP,
// h_scale * sv and bv over VN) and a full and an empty mbarrier a stage.
// The plan (kernels/lowrank_conv.lr_smem_bytes) computes the same sum.
__host__ __device__ constexpr size_t lw_smem(int rp, int vn, int stages,
                                             int c) {
  return 1024 + lw_main(rp, stages, c) + LW_BM * 128 +
         static_cast<size_t>(vn) * 128 + 2 * lw_vlin(rp, vn) +
         4 * (2 * static_cast<size_t>(rp) + 2 * static_cast<size_t>(vn)) +
         16 * static_cast<size_t>(stages);
}

struct LrArgs {
  const int8_t* v;
  const float* su;
  const float* bu;
  const float* sv;
  const float* bv;
  void* out;
  int M, K1, R, N, relu, out_int8, stages;
  float sx, h_scale, inv_h_scale, h_qmax, inv_out_scale, out_qmax;
};

// 16 bytes from global to shared memory, the last 16 - n of them zeros
// and not read (n of 16 bytes lie inside the source).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int RP_, int VN, int C_>
__global__ void __launch_bounds__(LW_THREADS, 2)
lr_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tu, const LrArgs a) {
  constexpr int STAGE = (LW_BM + RP_) * LW_BK;   // bytes a stage
  constexpr int LDP = RP_ + LW_PAD;             // partial row, in int32
  constexpr int VLIN = static_cast<int>(lw_vlin(RP_, VN));
  extern __shared__ __align__(16) unsigned char lw_raw[];
  unsigned char* sm =
      lw_raw + ((1024 - (smem_u32(lw_raw) & 1023)) & 1023);
  const int stages = a.stages;
  unsigned char* hs = sm + lw_main(RP_, stages, C_);   // [128][128] h
  unsigned char* vs = hs + LW_BM * 128;                // [VN][128] v tile
  unsigned char* vlin = vs + VN * 128;                 // 2 x VLIN
  float* sus = reinterpret_cast<float*>(vlin + 2 * VLIN);   // [RP] sx*su
  float* bus = sus + RP_;                                   // [RP]
  float* svs = bus + RP_;                         // [VN] h_scale * sv
  float* bvs = svs + VN;                          // [VN]
  const uint32_t bars = smem_u32(bvs + VN);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int rank = C_ == 1 ? 0 : static_cast<int>(blockIdx.x);
  const int m0 = blockIdx.y * LW_BM;
  const int nk = (a.K1 + LW_BK - 1) / LW_BK;
  const int k_lo = rank * nk / C_, k_hi = (rank + 1) * nk / C_;
  const int nt = (a.N + VN - 1) / VN;
  const int t_lo = rank * nt / C_, t_hi = (rank + 1) * nt / C_;
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / 32, lane = tid % 32;

  // The epilogues' scales, loaded now so that their latency hides behind
  // the main loop (to shared memory after it): rank column tid (0 at R and
  // above) and column tid of this rank's first COUT tile.
  const bool r_in = tid < RP_ && tid < a.R;
  const float suv = r_in ? __fmul_rn(a.sx, a.su[tid]) : 0.0f;
  const float buv = r_in ? a.bu[tid] : 0.0f;
  const int n_first = t_lo * VN + tid;
  const bool n_in = t_lo < t_hi && tid < VN && n_first < a.N;
  const float svv = n_in ? __fmul_rn(a.h_scale, a.sv[n_first]) : 0.0f;
  const float bvv = n_in ? a.bv[n_first] : 0.0f;

  // v rows of COUT tile t (one contiguous run of K-major v) into linear
  // buffer b, 16-byte copies from the aligned address at or before it; a
  // tile past this rank's share commits an empty group.
  auto load_v = [&](int t, int b) {
    if (t < t_hi) {
      const size_t lo = static_cast<size_t>(t) * VN * a.R;
      const size_t hi = static_cast<size_t>(min((t + 1) * VN, a.N)) * a.R;
      const size_t start = lo & ~static_cast<size_t>(15);
      unsigned char* dst = vlin + b * VLIN;
      for (size_t o = start + 16 * static_cast<size_t>(tid); o < hi;
           o += 16 * LW_THREADS)
        cp_async16(dst + (o - start), a.v + o,
                   static_cast<int>(hi - o < 16 ? hi - o : 16));
    }
    cp_async_commit();
  };
  load_v(t_lo, 0);
  load_v(t_lo + 1, 1);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * LW_CONSUMERS);   // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 1. u stage
  int acc[RP_ / 2];
#pragma unroll
  for (int i = 0; i < RP_ / 2; ++i) acc[i] = 0;
  if (warp == 4 * LW_CONSUMERS) {
    // the producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < k_hi - k_lo; ++i) {
        const int s = i % stages;
        mbar_wait(empty(s), ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t dst = smem_u32(sm + static_cast<size_t>(s) * STAGE);
        const int k = (k_lo + i) * LW_BK;
        tma_load(dst, &tx, full(s), k, m0);
        tma_load(dst + LW_BM * LW_BK, &tu, full(s), k, 0);
      }
    }
  } else {
    const int wgi = warp / 4;
    for (int i = 0; i < k_hi - k_lo; ++i) {
      const int s = i % stages;
      mbar_wait(full(s), (i / stages) & 1);
      __syncwarp();           // converged for the .aligned wgmma ops
      const uint32_t xa = smem_u32(sm + static_cast<size_t>(s) * STAGE) +
                          wgi * 64 * LW_BK;
      const uint32_t ua = smem_u32(sm + static_cast<size_t>(s) * STAGE) +
                          LW_BM * LW_BK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LW_BK / 32; ++kk)
        Wgmma<RP_>::mma(acc, sw128_desc(xa + 32 * kk),
                        sw128_desc(ua + 32 * kk));
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty(s));
    }
  }
  __syncthreads();            // the ring is drained: the partials overlay it
  if (tid < RP_) {
    sus[tid] = suv;
    bus[tid] = buv;
  }
  if (tid < VN) {
    svs[tid] = svv;
    bvs[tid] = bvv;
  }
  // int8 h of rank column c from its int32 sum: 0 at R and above
  auto hq = [&](int sum, int c) -> int8_t {
    return c < a.R ? requant(dequant(sum, sus[c], true, bus[c], 0),
                             a.inv_h_scale, a.h_qmax)
                   : int8_t(0);
  };

  // 2. h into the swizzled tile(s)
  if constexpr (C_ == 1) {
    __syncthreads();          // the scales are parked
    if (warp < 4 * LW_CONSUMERS) {
      const int r0 = (warp / 4) * 64;
#pragma unroll
      for (int i = 0; i < RP_ / 2; i += 2) {
        const int r = r0 + wg_frag_row(i, warp % 4, lane);
        const int c = wg_frag_col(i, lane);
        *reinterpret_cast<char2*>(hs + swz(r, c)) =
            make_char2(hq(acc[i], c), hq(acc[i + 1], c + 1));
      }
    }
    fence_proxy_async();
    __syncthreads();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    int* part = reinterpret_cast<int*>(sm);     // [LW_BM][LDP]
    if (warp < 4 * LW_CONSUMERS)
      store_partial<RP_>(part, LDP, acc, warp, lane);
    cluster.sync();

    // rank r sums rows [r * 128/C, (r + 1) * 128/C) of the partials, four
    // columns a thread, and stores the int8 h rows into every block's
    // tile (its own included)
    constexpr int TPR = RP_ / 4;               // threads over a tile row
    constexpr int RPP = LW_THREADS / TPR;      // rows a pass
    static_assert(LW_THREADS % TPR == 0, "fixed columns a thread");
    constexpr int ROWS = LW_BM / C_;
    const int col = (tid % TPR) * 4;
    for (int r = rank * ROWS + tid / TPR; r < (rank + 1) * ROWS; r += RPP) {
      const int4 s = cluster_sum4<C_>(cluster, part + r * LDP + col, rank);
      const uint32_t word =
          static_cast<uint32_t>(static_cast<uint8_t>(hq(s.x, col))) |
          static_cast<uint32_t>(static_cast<uint8_t>(hq(s.y, col + 1)))
              << 8 |
          static_cast<uint32_t>(static_cast<uint8_t>(hq(s.z, col + 2)))
              << 16 |
          static_cast<uint32_t>(static_cast<uint8_t>(hq(s.w, col + 3)))
              << 24;
      uint32_t* dst = reinterpret_cast<uint32_t*>(hs + swz(r, col));
#pragma unroll
      for (int q = 0; q < C_; ++q) *cluster.map_shared_rank(dst, q) = word;
    }
    fence_proxy_async();
    cluster.sync();           // every block's h is whole; no partial is read
    fence_proxy_async();
  }

  // 3. v stage: this rank's COUT tiles, the next tile's rows in flight
  const uint32_t ha = smem_u32(hs) + (warp / 4) * 64 * 128;
  const uint32_t va = smem_u32(vs);
  for (int t = t_lo; t < t_hi; ++t) {
    const int b = (t - t_lo) & 1;
    const int n0 = t * VN;
    cp_async_wait_1();        // tile t's rows landed (the next may fly)
    __syncthreads();          // for every thread; the last tile consumed
    {
      // v's rows n0.. as swizzled K-major rows of the tile, 16 bytes a
      // thread: bytes past R within a row are multiplied by h's zero
      // columns, rows past N land in outputs that are not stored
      const unsigned char* src =
          vlin + b * VLIN + ((static_cast<size_t>(n0) * a.R) & 15);
      const int kc = (a.R + 15) / 16;
      for (int c = tid; c < VN * kc; c += LW_THREADS) {
        const int j = c / kc, k = (c - j * kc) * 16;
        const unsigned char* p = src + j * a.R + k;
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = static_cast<uint32_t>(p[4 * q]) |
                 static_cast<uint32_t>(p[4 * q + 1]) << 8 |
                 static_cast<uint32_t>(p[4 * q + 2]) << 16 |
                 static_cast<uint32_t>(p[4 * q + 3]) << 24;
        *reinterpret_cast<uint4*>(vs + swz(j, k)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (t > t_lo && tid < VN) {
        const int n = n0 + tid;
        svs[tid] = n < a.N ? __fmul_rn(a.h_scale, a.sv[n]) : 0.0f;
        bvs[tid] = n < a.N ? a.bv[n] : 0.0f;
      }
    }
    fence_proxy_async();
    __syncthreads();
    load_v(t + 2, b);         // refill the buffer just read
    if (warp < 4 * LW_CONSUMERS) {
      int acc2[VN / 2];
#pragma unroll
      for (int i = 0; i < VN / 2; ++i) acc2[i] = 0;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < RP_ / 32; ++kk)
        Wgmma<VN>::mma(acc2, sw128_desc(ha + 32 * kk),
                       sw128_desc(va + 32 * kk));
      wgmma_commit();
      wgmma_wait_all();
      const int r0 = (warp / 4) * 64;
#pragma unroll
      for (int i = 0; i < VN / 2; i += 2) {
        const int r = r0 + wg_frag_row(i, warp % 4, lane);
        const int c = wg_frag_col(i, lane);
        if (m0 + r >= a.M || n0 + c >= a.N) continue;
        store2(a, m0 + r, n0 + c,
               dequant(acc2[i], svs[c], true, bvs[c], a.relu),
               dequant(acc2[i + 1], svs[c + 1], true, bvs[c + 1], a.relu));
      }
    }
  }
}

template <int RP_, int VN, int C_>
int launch_lw(const CUtensorMap& tx, const CUtensorMap& tu, const LrArgs& a,
              size_t smem, cudaStream_t st) {
  static size_t allowed[64] = {};
  return launch_clusters(lr_wgmma_kernel<RP_, VN, C_>, allowed,
                         dim3(C_, (a.M + LW_BM - 1) / LW_BM, 1), LW_THREADS,
                         smem, C_, st, tx, tu, a);
}

template <int RP_, int VN>
int launch_lw_c(const CUtensorMap& tx, const CUtensorMap& tu,
                const LrArgs& a, int C, size_t smem, cudaStream_t st) {
  switch (C) {
    case 1: return launch_lw<RP_, VN, 1>(tx, tu, a, smem, st);
    case 2: return launch_lw<RP_, VN, 2>(tx, tu, a, smem, st);
    case 4: return launch_lw<RP_, VN, 4>(tx, tu, a, smem, st);
    case 8: return launch_lw<RP_, VN, 8>(tx, tu, a, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int RP_>
int launch_lw_rp(const void* x, const void* u, const LrArgs& a, int vn,
                 int C, size_t smem, cudaStream_t st) {
  if (smem < lw_smem(RP_, vn, a.stages, C))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tu;
  if (!encode(&tx, x, a.M, a.K1, LW_BM) || !encode(&tu, u, a.R, a.K1, RP_))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (vn) {
    case 32: return launch_lw_c<RP_, 32>(tx, tu, a, C, smem, st);
    case 64: return launch_lw_c<RP_, 64>(tx, tu, a, C, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The mma.sync kernel: patches (M,K1) row-major, u and v K-major, any K1
// and alignment (vec_*: the operand takes 16-byte loads).
extern "C" int lowrank_conv_launch(
    const void* x, const void* u, const void* v, const void* su,
    const void* bu, const void* sv, const void* bv, void* out, int M, int K1,
    int R, int N, float sx, float h_scale, float inv_h_scale, float h_qmax,
    int relu, int out_int8, float inv_out_scale, float out_qmax, int vec_x,
    int vec_u, int vec_v, void* stream) {
  if (R < 1 || R > RP) return static_cast<int>(cudaErrorInvalidValue);
  lr_kernel<<<(M + BM - 1) / BM, THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(u),
      static_cast<const int8_t*>(v), static_cast<const float*>(su),
      static_cast<const float*>(bu), static_cast<const float*>(sv),
      static_cast<const float*>(bv), out, M, K1, R, N, sx, h_scale,
      inv_h_scale, h_qmax, relu, out_int8, inv_out_scale, out_qmax, vec_x,
      vec_u, vec_v);
  return static_cast<int>(cudaGetLastError());
}

// The TMA + wgmma kernel: patches (M,K1) row-major, u and v K-major, all
// three 16-byte aligned, K1 % 16 == 0; the plan (BM 128, RP, VN, stages,
// cluster C, shared memory bytes) from kernels/lowrank_conv.lr_plan.
extern "C" int lowrank_conv_wgmma_launch(
    const void* x, const void* u, const void* v, const void* su,
    const void* bu, const void* sv, const void* bv, void* out, int M, int K1,
    int R, int N, float sx, float h_scale, float inv_h_scale, float h_qmax,
    int relu, int out_int8, float inv_out_scale, float out_qmax, int bm,
    int rp, int vn, int stages, int C, int smem_bytes, void* stream) {
  if (bm != LW_BM || R < 1 || R > rp || stages < 1 ||
      stages > LW_MAX_STAGES || C < 1 || C > LW_MAX_CLUSTER ||
      (C & (C - 1)) != 0 || K1 % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || smem_bytes < 0 ||
      (M + LW_BM - 1) / LW_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const LrArgs a{static_cast<const int8_t*>(v),
                 static_cast<const float*>(su),
                 static_cast<const float*>(bu),
                 static_cast<const float*>(sv),
                 static_cast<const float*>(bv),
                 out,
                 M,
                 K1,
                 R,
                 N,
                 relu,
                 out_int8,
                 stages,
                 sx,
                 h_scale,
                 inv_h_scale,
                 h_qmax,
                 inv_out_scale,
                 out_qmax};
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  switch (rp) {
    case 32: return launch_lw_rp<32>(x, u, a, vn, C, smem, st);
    case 64: return launch_lw_rp<64>(x, u, a, vn, C, smem, st);
    case 96: return launch_lw_rp<96>(x, u, a, vn, C, smem, st);
    case 128: return launch_lw_rp<128>(x, u, a, vn, C, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
