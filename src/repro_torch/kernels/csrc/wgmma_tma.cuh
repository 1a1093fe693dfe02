// Hopper building blocks shared by the TMA + wgmma kernels
// (quant_matmul.cu, lowrank_conv.cu): the mbarrier ring, 2-D TMA loads and
// their tensor maps, the 128-byte swizzle, the s8 wgmma steps and their
// accumulator layout, the sum of int32 partial tiles over a cluster's
// distributed shared memory and the paired epilogue store.
//
// A ring stage is guarded by a full and an empty mbarrier: one producer
// lane waits on `empty`, arms `full` with the stage's bytes and issues the
// TMA loads; the consumer warps wait on `full`, run wgmma straight from the
// swizzled tiles and arrive on `empty`.  Tiles are K-major with 128-byte
// rows in the 128-byte swizzle (16-byte chunk c of row r stored at chunk
// c ^ (r % 8) of a 1024-byte-aligned atom): the layout TMA writes and
// sw128_desc names, and the one swz() gives for tiles that threads write
// themselves (which then need fence_proxy_async before wgmma reads them).
#pragma once
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "int8_tiles.cuh"

namespace wgmma_tma {

constexpr int TMA_BOX_K = 128;             // bytes of K a tile row holds

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

// Byte offset of (row r, byte c) in a tile of 128-byte rows in the
// 128-byte swizzle, from the tile's 1024-byte-aligned start.
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + (c ^ ((r & 7) << 4));
}

// Orders this thread's generic-proxy stores to shared memory (local, or a
// peer's through distributed shared memory) before later wgmma reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
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

// D (+)= A * B for a 64 x BN x 32 step: A the warpgroup's 64 K-major rows,
// B BN K-major rows, both from shared memory; d holds the warpgroup's
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

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(int (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
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

// The int32 accumulators of consumer warp `warp` (warpgroup warp / 4, 64
// rows each) into a partial tile part[row * ldp + col], two columns a store.
template <int BN_>
__device__ __forceinline__ void store_partial(int* part, int ldp,
                                              const int (&acc)[BN_ / 2],
                                              int warp, int lane) {
  const int r0 = (warp / 4) * 64;
#pragma unroll
  for (int v = 0; v < BN_ / 2; v += 2) {
    const int r = r0 + wg_frag_row(v, warp % 4, lane);
    const int c = wg_frag_col(v, lane);
    *reinterpret_cast<int2*>(part + r * ldp + c) =
        make_int2(acc[v], acc[v + 1]);
  }
}

// Four int32 columns at `src` summed over the C partial tiles of a cluster:
// this block's own and the C - 1 peers' at the same offset, the remote
// loads in flight together.  Integer sums are exact in any order.
template <int C_>
__device__ __forceinline__ int4 cluster_sum4(
    cooperative_groups::cluster_group& cluster, const int* src, int rank) {
  int4 p[C_];
  p[0] = *reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 1; q < C_; ++q)
    p[q] = *cluster.map_shared_rank(reinterpret_cast<const int4*>(src),
                                    (rank + q) % C_);
  int4 s = p[0];
#pragma unroll
  for (int q = 1; q < C_; ++q) {
    s.x += p[q].x;
    s.y += p[q].y;
    s.z += p[q].z;
    s.w += p[q].w;
  }
  return s;
}

// The end of a cluster's shared-memory lifetime: no memory ordering is
// needed (the peers only read), so the arrive is relaxed and the block's
// global stores need not drain first.
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// y0, y1 = the epilogue of two neighbouring outputs (m, n) and (m, n + 1)
// of a row-major (M, N) output (a.out, int8 on a.inv_out_scale when
// a.out_int8, else fp32), written as a pair where the row allows it.
template <typename Args>
__device__ __forceinline__ void store2(const Args& a, int m, int n, float y0,
                                       float y1) {
  const size_t o = static_cast<size_t>(m) * a.N + n;
  const bool both = n + 1 < a.N;
  if (a.out_int8) {
    int8_t* out = static_cast<int8_t*>(a.out) + o;
    const int8_t q0 = int8_tiles::requant(y0, a.inv_out_scale, a.out_qmax);
    const int8_t q1 = int8_tiles::requant(y1, a.inv_out_scale, a.out_qmax);
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

// Launches `kern` on `grid` in clusters of C blocks along x, `threads` a
// block and `smem` bytes of dynamic shared memory, raising the kernel's
// shared-memory limit once for each device, to the most a launch has asked
// for so far (`allowed`: one array for each kernel instantiation).
template <typename... P, typename... A>
int launch_clusters(void (*kern)(P...), size_t (&allowed)[64], dim3 grid,
                    int threads, size_t smem, int C, cudaStream_t st,
                    const A&... args) {
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
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once (nothing links
// libcuda).
inline EncodeTiled encoder() {
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
inline bool encode(CUtensorMap* map, const void* base, int rows, int K,
                   int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {TMA_BOX_K, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma_tma
