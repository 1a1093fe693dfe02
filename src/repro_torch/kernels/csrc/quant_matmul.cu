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
// product and the epilogue live in int8_tiles.cuh, shared with the fused
// low-rank kernel.
//
// Left for later: an implicit-GEMM conv that gathers its patches inside
// the kernel instead of from an im2col in device memory, a persistent
// (stream-K) scheduler, and CUDA graphs around the serving pass.
#include <cooperative_groups.h>
#include <cuda.h>

#include "int8_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace int8_tiles;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA tile (inner coordinate c0, outer c1) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in
// the 128-byte swizzle: start address >> 4, leading offset 1 (unused by a
// swizzled K-major layout), stride 1024 bytes between 8-row groups, layout
// type 1 (SWIZZLE_128B).  Advancing the start by 32 bytes selects the next
// k32 slice of the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (+)= A * B for a 64 x BN x 32 step: A the warpgroup's 64 rows of x, B
// BN rows of K-major w, both from shared memory; d holds the warpgroup's
// BN / 2 int32 accumulators of this thread.
template <int BN_>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
  }
};

// Accumulator v of a thread of a warpgroup (warp w of 4, lane l) sits at
// row 16w + l/4 (+8 for the second pair of each four) and column
// 8 * (v / 4) + 2 * (l % 4) + (v & 1) of the warpgroup's 64 x BN tile.
__device__ __forceinline__ int wg_frag_row(int v, int w, int lane) {
  return 16 * w + lane / 4 + ((v >> 1) & 1) * 8;
}
__device__ __forceinline__ int wg_frag_col(int v, int lane) {
  return 8 * (v >> 2) + 2 * (lane % 4) + (v & 1);
}

// The end of a cluster's shared-memory lifetime: no memory ordering is
// needed (the peers only read), so the arrive is relaxed and the block's
// global stores need not drain first.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// y0, y1 = the epilogue of two neighbouring outputs (m, n) and (m, n + 1),
// written as a pair where the row allows it.
__device__ __forceinline__ void store2(const WgArgs& a, int m, int n,
                                       float y0, float y1) {
  const size_t o = static_cast<size_t>(m) * a.N + n;
  const bool both = n + 1 < a.N;
  if (a.out_int8) {
    int8_t* out = static_cast<int8_t*>(a.out) + o;
    const int8_t q0 = requant(y0, a.inv_out_scale, a.out_qmax);
    const int8_t q1 = requant(y1, a.inv_out_scale, a.out_qmax);
    if (both && a.N % 2 == 0) {
      *reinterpret_cast<char2*>(out) = make_char2(q0, q1);
    } else {
      out[0] = q0;
      if (both) out[1] = q1;
    }
  } else {
    float* out = static_cast<float*>(a.out) + o;
    if (both && a.N % 2 == 0) {
      *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
    } else {
      out[0] = y0;
      if (both) out[1] = y1;
    }
  }
}

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
    if (warp < 4 * WG_CONSUMERS) {
      const int r0 = (warp / 4) * 64;
#pragma unroll
      for (int v = 0; v < BN_ / 2; v += 2) {
        const int r = r0 + wg_frag_row(v, warp % 4, lane);
        const int c = wg_frag_col(v, lane);
        *reinterpret_cast<int2*>(part + r * LDP + c) =
            make_int2(acc[v], acc[v + 1]);
      }
    }
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
      const int* src = part + r * LDP + col;
      int4 p[C_];
      p[0] = *reinterpret_cast<const int4*>(src);
#pragma unroll
      for (int q = 1; q < C_; ++q)
        p[q] = *cluster.map_shared_rank(reinterpret_cast<const int4*>(src),
                                        (rank + q) % C_);
      const int m = m0 + r;
      if (m >= a.M) continue;
      int sum[4] = {p[0].x, p[0].y, p[0].z, p[0].w};
#pragma unroll
      for (int q = 1; q < C_; ++q) {
        sum[0] += p[q].x;
        sum[1] += p[q].y;
        sum[2] += p[q].z;
        sum[3] += p[q].w;
      }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, K) int8 operand with row stride K bytes, read in boxes of
// `box_rows` rows x 128 bytes of K in the 128-byte swizzle; the hardware
// fills the boxes' out-of-range parts with zeros.
bool encode(CUtensorMap* map, const void* base, int rows, int K,
            int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {WG_BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN_, int C_>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                 const WgArgs& a, size_t smem, cudaStream_t st) {
  auto kern = qmm_wgmma_kernel<BN_, C_>;
  // The shared-memory limit is raised once for each device, to the most
  // a launch of this instantiation has asked for so far.
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C_, (a.N + BN_ - 1) / BN_, (a.M + WG_BM - 1) / WG_BM);
  cfg.blockDim = dim3(WG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C_;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tx, tw, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
