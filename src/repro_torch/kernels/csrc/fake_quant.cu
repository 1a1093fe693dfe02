// Per-column symmetric fake quantization for Hopper (sm_90a) in one launch
// over thread-block clusters, bound to Python with ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/fake_quant.py
// (`fake_quant_fused` / `_fused_kernel`, and the two-pass `fake_quant` /
// `_amax_kernel` + `_quant_kernel`, which the reference takes where a
// (K, 256) fp32 stripe overflows its VMEM; a cluster's shared memory holds
// it, so both wrappers of kernels/fake_quant.py launch this kernel): for a
// 2-D weight w (K, N) in fp32 or bf16, each column gets
//     scale = max(amax, 1e-8) * fp32(1/qmax)       amax = max_k |w[k, n]|
//     out   = clip(rint(w / scale), -qmax-1, qmax) * scale
// in fp32, stored in w's dtype (bf16 rounded to nearest even).  The
// division is IEEE (__fdiv_rn), the product __fmul_rn, and the reciprocal
// of qmax comes from the host (kernels/ref.recip32, the constant XLA folds
// the reference's division into), so the result equals the plain version
// (kernels/ref.fake_quant_ref) bit for bit.  A max does not depend on the
// order of its terms, so the cluster's reduction is exact.
//
// What bounds it on an H100.  Seven fp32 operations an element against
// reading w once and writing the output once: bytes.  At tinyllama's
// (2048, 5632) or (5632, 2048) bf16 that is 46 MB, 13.8 us at 3.35 TB/s.
// The Pallas kernel holds a whole (K, bn) column stripe in VMEM; one SM's
// shared memory cannot, and one block per stripe leaves most of the 132
// SMs idle at N = 2048 or 256 (32 and 4 stripes of 64 columns).
//
// Design.  The grid is (ceil(N / BN), C) in clusters of C blocks along K;
// block r of a cluster owns rows [r*R, min((r+1)*R, K)) of a BN-column
// stripe, and the launch plan (kernels/fake_quant.fused_plan, which takes
// the non-portable cluster of 16 where K is tall, so that a tall weight
// keeps 128-byte stripe rows in small slices) picks BN, C and R so that
// enough blocks run.  Each block
//   1. copies its (R, BN) slice into shared memory once (16-byte cp.async
//      where the rows are 16-byte aligned, element loads otherwise),
//   2. reduces its column |w| maxima (warp shuffles, then a shared-memory
//      integer atomicMax: non-negative floats order as their bits) into
//      BN partial maxima in its shared memory,
//   3. cluster.sync(),
//   4. reads the C partials of its columns from its peers through
//      distributed shared memory (cluster.map_shared_rank) and forms the
//      scales,
//   5. quantizes its slice out of shared memory, 16-byte stores,
//   6. cluster.sync() before exit, so that no block's shared memory goes
//      away while a peer still reads it.
// w is read from device memory once and nothing is written but the
// output.  Where a slice cannot fit in shared memory (a very tall, narrow
// head such as (100000, 10)), the plan says so and the block walks its
// slice twice from device memory instead (STAGED = false).
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 16;  // above the portable 8 by opt-in
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// V consecutive elements as fp32: one 16-byte load where V > 1.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&e)[V]) {
  if constexpr (V == 1) {
    e[0] = to_f32(*p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = to_f32(x[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* p, const float (&e)[V]) {
  if constexpr (V == 1) {
    from_f32(e[0], p);
  } else {
    uint4 u;
    T* x = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) from_f32(e[i], x + i);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ float quantize(float w, float scale, float qmax) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(w, scale)), -qmax - 1.0f),
                        qmax);
  return __fmul_rn(q, scale);
}

// Shared memory a block takes: the partial maxima and the scales (BN
// floats each), then the staged (R, BN) slice in w's dtype.
template <typename T, int BN, bool STAGED>
constexpr size_t smem_need(int R) {
  return 2 * BN * sizeof(float) +
         (STAGED ? static_cast<size_t>(R) * BN * sizeof(T) : 0);
}

// VEC: rows are 16-byte aligned (N * sizeof(T) % 16 == 0, both pointers
// aligned), so a thread moves V = 16 / sizeof(T) columns at a time and a
// vector lies wholly inside or outside the matrix.
template <typename T, int BN, bool VEC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
fq_cluster_kernel(const T* __restrict__ w, T* __restrict__ out, int K, int N,
                  int R, float qmax, float inv_qmax) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int CPR = BN / V;            // threads across a stripe row
  constexpr int RSTEP = THREADS / CPR;   // rows the block covers at once
  static_assert(THREADS % CPR == 0, "a row must split evenly");
  extern __shared__ __align__(16) unsigned char smem[];
  float* pmax = reinterpret_cast<float*>(smem);    // [BN] partial maxima
  float* scale = pmax + BN;                        // [BN]
  T* slice = reinterpret_cast<T*>(scale + BN);     // [R][BN] when STAGED

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int row0 = rank * R;
  const int rows = max(0, min(R, K - row0));
  const int t = threadIdx.x, cv = t % CPR;
  const int col = blockIdx.x * BN + cv * V;        // this thread's columns
  const bool in = col < N;
  const T* src = w + static_cast<size_t>(row0) * N + col;
  T* dst = out + static_cast<size_t>(row0) * N + col;

  if (t < BN) pmax[t] = 0.0f;
  if constexpr (STAGED) {
    if (in) {
#pragma unroll 8
      for (int r = t / CPR; r < rows; r += RSTEP) {
        T* s = slice + r * BN + cv * V;
        if constexpr (VEC)
          cp_async16(s, src + static_cast<size_t>(r) * N);
        else
          *s = src[static_cast<size_t>(r) * N];
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  auto element = [&](int r, float (&e)[V]) {
    if constexpr (STAGED)
      load_f32<T, V>(slice + r * BN + cv * V, e);
    else
      load_f32<T, V>(src + static_cast<size_t>(r) * N, e);
  };

  float mx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mx[i] = 0.0f;
  if (in) {
#pragma unroll 8
    for (int r = t / CPR; r < rows; r += RSTEP) {
      float e[V];
      element(r, e);
#pragma unroll
      for (int i = 0; i < V; ++i) mx[i] = fmaxf(mx[i], fabsf(e[i]));
    }
  }
  // lanes l, l + CPR, ... of a warp hold the same columns
#pragma unroll
  for (int o = 16; o >= CPR; o >>= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], o));
  }
  if (in && (t % 32) < CPR) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      atomicMax(reinterpret_cast<int*>(pmax) + cv * V + i,
                __float_as_int(mx[i]));
  }
  cluster.sync();

  if (t < BN) {           // the C remote loads in flight together
    float a = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q < C) a = fmaxf(a, cluster.map_shared_rank(pmax, q)[t]);
    }
    scale[t] = __fmul_rn(fmaxf(a, 1e-8f), inv_qmax);
  }
  __syncthreads();

  if (in) {
    float sc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sc[i] = scale[cv * V + i];
#pragma unroll 8
    for (int r = t / CPR; r < rows; r += RSTEP) {
      float e[V];
      element(r, e);
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = quantize(e[i], sc[i], qmax);
      store_f32<T, V>(dst + static_cast<size_t>(r) * N, e);
    }
  }
  cluster.sync();
}

template <typename T, int BN, bool VEC, bool STAGED>
int launch(const void* w, void* out, int K, int N, int C, int R,
           size_t smem, float qmax, float inv_qmax, cudaStream_t st) {
  // The kernel's attributes, set once for each device: the most dynamic
  // shared memory a launch has asked for, and the opt-in to non-portable
  // clusters (C = 16).
  static size_t allowed[64] = {};
  static bool non_portable[64] = {};
  auto kern = fq_cluster_kernel<T, BN, VEC, STAGED>;
  if (smem < smem_need<T, BN, STAGED>(R))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  if (C > 8 && !non_portable[dev]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    non_portable[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, C, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(w),
                         static_cast<T*>(out), K, N, R, qmax, inv_qmax);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int launch_bn(const void* w, void* out, int K, int N, int C, int R,
              size_t smem, int staged, int vec, float qmax, float inv_qmax,
              cudaStream_t st) {
  if (staged && vec)
    return launch<T, BN, true, true>(w, out, K, N, C, R, smem, qmax,
                                     inv_qmax, st);
  if (staged)
    return launch<T, BN, false, true>(w, out, K, N, C, R, smem, qmax,
                                      inv_qmax, st);
  if (vec)
    return launch<T, BN, true, false>(w, out, K, N, C, R, smem, qmax,
                                      inv_qmax, st);
  return launch<T, BN, false, false>(w, out, K, N, C, R, smem, qmax,
                                     inv_qmax, st);
}

template <typename T>
int launch_t(const void* w, void* out, int K, int N, int BN, int C, int R,
             size_t smem, int staged, int vec, float qmax, float inv_qmax,
             cudaStream_t st) {
  switch (BN) {
    case 16: return launch_bn<T, 16>(w, out, K, N, C, R, smem, staged, vec,
                                     qmax, inv_qmax, st);
    case 32: return launch_bn<T, 32>(w, out, K, N, C, R, smem, staged, vec,
                                     qmax, inv_qmax, st);
    case 64: return launch_bn<T, 64>(w, out, K, N, C, R, smem, staged, vec,
                                     qmax, inv_qmax, st);
    case 128: return launch_bn<T, 128>(w, out, K, N, C, R, smem, staged,
                                       vec, qmax, inv_qmax, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// w and out (K, N) both fp32 (bf16 == 0) or both bf16; the plan (BN, C,
// R, smem_bytes, staged) comes from kernels/fake_quant.fused_plan, vec
// from the wrapper's alignment check.
extern "C" int fake_quant_fused_launch(const void* w, void* out, int K,
                                       int N, int BN, int C, int R,
                                       int smem_bytes, int staged, int vec,
                                       int bf16, float qmax, float inv_qmax,
                                       void* stream) {
  if (K <= 0 || N <= 0 || C < 1 || C > MAX_CLUSTER || R < 1 ||
      static_cast<long long>(R) * C < K || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  return bf16 ? launch_t<__nv_bfloat16>(w, out, K, N, BN, C, R, smem, staged,
                                        vec, qmax, inv_qmax, st)
              : launch_t<float>(w, out, K, N, BN, C, R, smem, staged, vec,
                                qmax, inv_qmax, st);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
