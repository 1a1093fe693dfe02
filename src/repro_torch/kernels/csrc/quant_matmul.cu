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
// weights and the output at 3.35 TB/s): the calls are bound by bytes.  The
// outputs are few (resnet34's stage 3 has 512 x 512 of them at 32 slots)
// and K long, so one tile a block leaves most SMs idle and a block's K loop
// is a long chain of dependent loads.
//
// Two kernels, chosen by the wrapper from the operands
// (kernels/quant_matmul.py):
//
// qmm_wgmma_kernel (K % 16 == 0, 16-byte aligned x and w, w K-major: the
// serving path's layout, core/export.py).  A block of two consumer
// warpgroups and one producer warp computes a 128 x BN output tile (BN 64,
// or 32 for a narrow head).  The producer keeps
// a ring of `stages` 128-byte-deep K tiles of x and w in flight with TMA
// (128-byte swizzle, the ragged M, N and K edges zero-filled by the
// hardware), each stage guarded by a full and an empty mbarrier; each
// consumer warpgroup runs four wgmma.m64nBNk32.s32.s8.s8 a stage on its 64
// rows, straight from the swizzled shared memory.  The epilogue's scales
// are loaded before the main loop and parked in shared memory after it.
// Unsplit (C = 1), each consumer thread runs the epilogue on its own
// accumulators.  Where the output has too few tiles to fill the card, a
// thread-block cluster of C (2 or 4) blocks
// shares one tile and splits its K tiles evenly; each block writes its
// int32 partial tile to shared memory (over the drained ring), and after a
// cluster barrier rank r sums rows [r * 128/C, (r+1) * 128/C) of the C
// partials over distributed shared memory and runs the epilogue on them.
// Integer sums are exact in any order, so every split gives the same bits.
// The launch plan (BN, stages, C, shared memory) comes from
// kernels/quant_matmul.qmm_plan, which keeps two blocks on an SM (one
// block an SM holds too few clusters at once for a split grid to run in
// one wave); the launcher refuses a plan whose shared memory is smaller
// than the layout.  The tensor maps are encoded on every call
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// nothing links libcuda).  scripts/qmm_plan_sweep.py times the plans and
// the phases of a block, on its own copy of this source that also takes
// BN 128, clusters of 8 and rings of 8.
//
// qmm_kernel (the rest: the stem's K = 27, mobilenetv2's K = 24, a
// misaligned operand).  One 64x64 output tile per block of 4 warps (2x2,
// 32x32 each); K advances in 64-byte steps.  x and w tiles are staged in
// shared memory with K contiguous (w is K-major on both routes: the
// wrapper relays a row-major w), byte by byte, rows padded to 80 bytes so
// the fragment loads are free of bank conflicts, and fed to
// mma.sync.m16n8k32 s8.
// Ragged M, N and K edges are masked with zeros.  The staging, the warp
// product and the epilogue live in int8_tiles.cuh, the TMA, mbarrier,
// wgmma and cluster-sum steps in wgmma_tma.cuh, both shared with the fused
// low-rank kernel.
//
// Left for later: an implicit-GEMM conv that gathers its patches inside
// the kernel instead of from an im2col in device memory, a persistent
// (stream-K) scheduler, and CUDA graphs around the serving pass.
#include <cooperative_groups.h>
#include <cuda.h>

#include "int8_tiles.cuh"
#include "wgmma_tma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace int8_tiles;
using namespace wgmma_tma;

// ---------------------------------------------------------------------
// qmm_kernel: mma.sync, any K.

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;   // smem row stride in bytes
constexpr int THREADS = 128;

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

  // Byte loads: this route serves the operands that 16-byte loads cannot
  // read (K % 16 != 0 or a misaligned base).  w[k][n] at w + n * K + k
  // (K-major): rows of N.
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_rows<BM, BK, LDS, THREADS, false>(xs, x, M, K, m0, k0);
    stage_rows<BN, BK, LDS, THREADS, false>(ws, w, N, K, n0, k0);
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

// ---------------------------------------------------------------------
// qmm_wgmma_kernel: TMA + wgmma, K split over a cluster.

constexpr int WG_BM = 128;                 // two consumer warpgroups
constexpr int WG_BK = 128;                 // bytes of K a stage
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;   // + a producer warp
constexpr int WG_PAD = 8;                  // int32 partial rows: BN + 8
constexpr int WG_MAX_CLUSTER = 4;          // qmm_plan's largest cluster
constexpr int WG_MAX_STAGES = 4;           // and ring

// Shared memory of a block: 1024 bytes to align the ring to the 128-byte
// swizzle's 1024-byte atom, the ring of stages (x tile 128 x 128 bytes, w
// tile BN x 128 bytes) or, after the main loop, the int32 partial tile
// [128][BN + 8] over it, then the tile's 128 row scales sx, its BN column
// scales sw and biases, and a full and an empty mbarrier a stage.  The
// plan (kernels/quant_matmul.qmm_smem_bytes) computes the same sum.
__host__ __device__ constexpr size_t wg_smem(int bn, int stages) {
  return 1024 +
         (static_cast<size_t>(stages) * (WG_BM + bn) * WG_BK >
                  static_cast<size_t>(WG_BM) * (bn + WG_PAD) * 4
              ? static_cast<size_t>(stages) * (WG_BM + bn) * WG_BK
              : static_cast<size_t>(WG_BM) * (bn + WG_PAD) * 4) +
         4 * (WG_BM + 2 * static_cast<size_t>(bn)) +
         16 * static_cast<size_t>(stages);
}

struct WgArgs {
  const float* sx;
  const float* sw;
  const float* bias;
  void* out;
  int M, N, K, relu, out_int8, stages;
  float inv_out_scale, out_qmax;
};

template <int BN_, int C_>
__global__ void __launch_bounds__(WG_THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw, const WgArgs a) {
  constexpr int STAGE = (WG_BM + BN_) * WG_BK;   // bytes a stage
  constexpr int LDP = BN_ + WG_PAD;             // partial row, in int32
  extern __shared__ __align__(16) unsigned char wg_raw[];
  unsigned char* sm =
      wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
  const int stages = a.stages;
  const size_t ring = static_cast<size_t>(stages) * STAGE;
  const size_t part_bytes = static_cast<size_t>(WG_BM) * LDP * 4;
  float* sxs = reinterpret_cast<float*>(
      sm + (ring > part_bytes ? ring : part_bytes));      // [WG_BM]
  float* sws = sxs + WG_BM;                               // [BN_]
  float* bs = sws + BN_;                                  // [BN_]
  const uint32_t bars = smem_u32(bs + BN_);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int rank = C_ == 1 ? 0 : static_cast<int>(blockIdx.x);
  const int n0 = blockIdx.y * BN_, m0 = blockIdx.z * WG_BM;
  const int nk = (a.K + WG_BK - 1) / WG_BK;
  const int k_lo = rank * nk / C_, k_hi = (rank + 1) * nk / C_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = static_cast<int>(threadIdx.x);

  // The epilogue's scales, loaded now so that their latency hides behind
  // the main loop (to shared memory after it): sx of row tid and sw, bias
  // of column tid of the tile.
  const float sxv = tid < WG_BM && m0 + tid < a.M ? a.sx[m0 + tid] : 0.0f;
  const bool col_in = tid < BN_ && n0 + tid < a.N;
  const float swv = col_in ? a.sw[n0 + tid] : 0.0f;
  const float bv = col_in && a.bias != nullptr ? a.bias[n0 + tid] : 0.0f;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * WG_CONSUMERS);   // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[BN_ / 2];
#pragma unroll
  for (int v = 0; v < BN_ / 2; ++v) acc[v] = 0;

  if (warp == 4 * WG_CONSUMERS) {
    // the producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < k_hi - k_lo; ++i) {
        const int s = i % stages;
        mbar_wait(empty(s), ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t dst = smem_u32(sm + static_cast<size_t>(s) * STAGE);
        const int k = (k_lo + i) * WG_BK;
        tma_load(dst, &tx, full(s), k, m0);
        tma_load(dst + WG_BM * WG_BK, &tw, full(s), k, n0);
      }
    }
  } else {
    const int wgi = warp / 4;
    for (int i = 0; i < k_hi - k_lo; ++i) {
      const int s = i % stages;
      mbar_wait(full(s), (i / stages) & 1);
      __syncwarp();           // converged for the .aligned wgmma ops
      const uint32_t xa = smem_u32(sm + static_cast<size_t>(s) * STAGE) +
                          wgi * 64 * WG_BK;
      const uint32_t wa = smem_u32(sm + static_cast<size_t>(s) * STAGE) +
                          WG_BM * WG_BK;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk)
        Wgmma<BN_>::mma(acc, sw128_desc(xa + 32 * kk),
                        sw128_desc(wa + 32 * kk));
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty(s));
    }
  }
  __syncthreads();            // the ring is drained: the partials overlay it
  if (tid < WG_BM) sxs[tid] = sxv;
  if (tid < BN_) {
    sws[tid] = swv;
    bs[tid] = bv;
  }
  const bool has_bias = a.bias != nullptr;

  if constexpr (C_ == 1) {
    // No split: each consumer thread runs the epilogue on its own
    // accumulators, two neighbouring columns at a time.
    __syncthreads();
    if (warp < 4 * WG_CONSUMERS) {
      const int r0 = (warp / 4) * 64;
#pragma unroll
      for (int v = 0; v < BN_ / 2; v += 2) {
        const int r = r0 + wg_frag_row(v, warp % 4, lane);
        const int c = wg_frag_col(v, lane);
        if (m0 + r >= a.M || n0 + c >= a.N) continue;
        const float sxm = sxs[r];
        store2(a, m0 + r, n0 + c,
               dequant(acc[v], __fmul_rn(sxm, sws[c]), has_bias, bs[c],
                       a.relu),
               dequant(acc[v + 1], __fmul_rn(sxm, sws[c + 1]), has_bias,
                       bs[c + 1], a.relu));
      }
    }
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    int* part = reinterpret_cast<int*>(sm);     // [WG_BM][LDP]
    if (warp < 4 * WG_CONSUMERS)
      store_partial<BN_>(part, LDP, acc, warp, lane);
    cluster.sync();

    // rank r sums and writes rows [r * 128/C, (r + 1) * 128/C) of the
    // tile, four columns a thread (fixed: WG_THREADS is a multiple of
    // BN/4), its own partial and the C - 1 remote ones in flight together
    constexpr int TPR = BN_ / 4;               // threads over a tile row
    constexpr int RPP = WG_THREADS / TPR;      // rows a pass
    static_assert(WG_THREADS % TPR == 0, "fixed columns a thread");
    constexpr int ROWS = WG_BM / C_;
    const int col = (tid % TPR) * 4;
    const float4 swq = *reinterpret_cast<const float4*>(sws + col);
    const float4 bq = *reinterpret_cast<const float4*>(bs + col);
    const float sw4[4] = {swq.x, swq.y, swq.z, swq.w};
    const float b4[4] = {bq.x, bq.y, bq.z, bq.w};
    for (int r = rank * ROWS + tid / TPR; r < (rank + 1) * ROWS; r += RPP) {
      const int m = m0 + r;
      if (m >= a.M) continue;
      const int4 s = cluster_sum4<C_>(cluster, part + r * LDP + col, rank);
      const int sum[4] = {s.x, s.y, s.z, s.w};
      const float sxm = sxs[r];
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = dequant(sum[j], __fmul_rn(sxm, sw4[j]), has_bias, b4[j],
                       a.relu);
      if (n0 + col < a.N) store2(a, m, n0 + col, y[0], y[1]);
      if (n0 + col + 2 < a.N) store2(a, m, n0 + col + 2, y[2], y[3]);
    }
    __syncwarp();
    cluster_sync_relaxed();   // every block's partials stay until read
  }
}

template <int BN_, int C_>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                 const WgArgs& a, size_t smem, cudaStream_t st) {
  static size_t allowed[64] = {};
  return launch_clusters(
      qmm_wgmma_kernel<BN_, C_>, allowed,
      dim3(C_, (a.N + BN_ - 1) / BN_, (a.M + WG_BM - 1) / WG_BM), WG_THREADS,
      smem, C_, st, tx, tw, a);
}

template <int BN_>
int launch_wgmma_bn(const void* x, const void* w, const WgArgs& a, int C,
                    size_t smem, cudaStream_t st) {
  if (smem < wg_smem(BN_, a.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  if (!encode(&tx, x, a.M, a.K, WG_BM) || !encode(&tw, w, a.N, a.K, BN_))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 1: return launch_wgmma<BN_, 1>(tx, tw, a, smem, st);
    case 2: return launch_wgmma<BN_, 2>(tx, tw, a, smem, st);
    case 4: return launch_wgmma<BN_, 4>(tx, tw, a, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The mma.sync kernel: x (M,K) row-major, w K-major (w[k][n] at
// w + n * K + k), any K and alignment.
extern "C" int quant_matmul_launch(const void* x, const void* w,
                                   const void* sx, const void* sw,
                                   const void* bias, void* out, int M, int N,
                                   int K, int relu, int out_int8,
                                   float inv_out_scale, float out_qmax,
                                   void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), out, M, N, K, relu, out_int8,
      inv_out_scale, out_qmax);
  return static_cast<int>(cudaGetLastError());
}

// The TMA + wgmma kernel: x (M,K) row-major and w K-major, both 16-byte
// aligned, K % 16 == 0; the plan (BM 128, BN 32/64, stages, cluster C,
// shared memory bytes) from kernels/quant_matmul.qmm_plan.
extern "C" int quant_matmul_wgmma_launch(
    const void* x, const void* w, const void* sx, const void* sw,
    const void* bias, void* out, int M, int N, int K, int relu, int out_int8,
    float inv_out_scale, float out_qmax, int bm, int bn, int stages, int C,
    int smem_bytes, void* stream) {
  if (bm != WG_BM || stages < 1 || stages > WG_MAX_STAGES || C < 1 ||
      C > WG_MAX_CLUSTER || (C & (C - 1)) != 0 || K % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || smem_bytes < 0 ||
      (M + WG_BM - 1) / WG_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgArgs a{static_cast<const float*>(sx),
                 static_cast<const float*>(sw),
                 static_cast<const float*>(bias),
                 out,
                 M,
                 N,
                 K,
                 relu,
                 out_int8,
                 stages,
                 inv_out_scale,
                 out_qmax};
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  switch (bn) {
    case 32: return launch_wgmma_bn<32>(x, w, a, C, smem, st);
    case 64: return launch_wgmma_bn<64>(x, w, a, C, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
