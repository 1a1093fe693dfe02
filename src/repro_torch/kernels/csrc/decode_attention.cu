// One-token GQA flash-decode attention for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/decode_attention.py:
// `decode_attention` / `_decode_kernel` (a bf16 or fp32 cache) and
// `decode_attention_int8` / `_decode_kernel_int8` (an int8 cache with fp32
// scales per (token, kv-head)).  The g = H / K query heads of kv-head kh of
// batch row b attend to the S slots of the cache k, v (B, S, K, D):
//     logit[h, s] = (fp32(q[b, kh*g + h]) * D**-0.5) . fp32(k[b, s, kh])
//     a masked slot (valid[s] false) gets -1e30
//     online softmax in fp32 over s, out = acc / max(l, 1e-30) in q's type
// and in the int8 variant each k (v) element is code * k_s[b, s, kh] in
// fp32.  -1e30, not -inf, as on the TPU: masked terms are corrected away by
// corr = exp(m_old - m_new) once a valid slot is seen, and a row whose
// slots are all masked comes out as the mean of v over the S slots.
//
// What bounds it on an H100.  Each cache element is read once and used
// for 2*g flops (g = 8 for tinyllama), far below the card's
// operations-per-byte line, so the kernel is bound by bytes: k and v (and
// their scales), q and the output once.  At tinyllama's decode shapes
// (B = 8, S = 584, K = 4, D = 64, bf16) that is 4.8 MB, 1.4 us at
// 3.35 TB/s.
//
// Design.  One block per (kv-head, batch row).  The g query heads of the
// group sit in shared memory as fp32, pre-scaled.  The block's 8 warps
// split the S slots in tiles of 32, and each warp keeps its own (m, l, acc)
// for the g heads.  In a tile, lane t owns slot s = tile + t and computes
// its g logits over the whole k row (16-byte loads); the tile's max and sum
// are warp shuffles; the probabilities go to shared memory; then lane t
// owns D/32 channels and accumulates p * v over the tile's rows, each row
// read coalesced by the warp.  At the end the warps' partials merge in
// shared memory.  The cache is read in its (B, S, K, D) layout, so nothing
// is transposed or copied (the TPU wrapper transposes it to (B, K, S, D)
// on every call), and an S that no tile divides is masked, not fitted.
//
// Shortfall: only B * K blocks run (32 at batch 8, on 32 of the card's 132
// SMs), each walking its slots with 8 warps, so the kernel cannot reach the
// byte bound at decode shapes.  Splitting S across blocks with a second
// merge pass (flash-decoding) is the fix; it is not done here.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// out[i] = fp32(p[i]) for N consecutive elements, in one vector load where
// N * sizeof(T) is 4, 8 or 16 bytes (the caller keeps p aligned to that).
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 16 || BYTES == 8 || BYTES == 4) {
    using V = std::conditional_t<BYTES == 16, uint4,
                                 std::conditional_t<BYTES == 8, uint2,
                                                    uint32_t>>;
    const V u = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

struct Args {
  const void* q;          // (B, H, D) TQ
  const void* k;          // (B, S, K, D) TKV
  const void* v;
  const float* ks;        // (B, S, K) fp32, int8 variant only
  const float* vs;
  const uint8_t* valid;   // (S,) bool
  void* out;              // (B, H, D) TQ
  int B, S, H, K, g;
  float scale;            // fp32(D**-0.5)
};

template <int D, int G>
constexpr size_t smem_bytes() {
  return sizeof(float) * (G * D + WARPS * G * 32 + WARPS * 32 +
                          2 * WARPS * G + WARPS * G * D);
}

// G is the group size rounded up to a power of two; heads g..G-1 hold
// zeros and are not written.
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(THREADS) decode_kernel(const Args a) {
  constexpr bool INT8 = std::is_same_v<TKV, int8_t>;
  constexpr int VEC = 16 / static_cast<int>(sizeof(TKV));  // per 16 bytes
  constexpr int EL = D / 32;               // channels a lane owns in p @ v
  extern __shared__ float smem[];
  float* qs = smem;                        // [G][D] scaled query group
  float* ps = qs + G * D;                  // [WARPS][G][32] probabilities
  float* vsc = ps + WARPS * G * 32;        // [WARPS][32] v scales (int8)
  float* mm = vsc + WARPS * 32;            // [WARPS][G] partial max
  float* ll = mm + WARPS * G;              // [WARPS][G] partial sum
  float* aa = ll + WARPS * G;              // [WARPS][G][D] partial acc

  const int kh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = a.S, K = a.K, g = a.g;
  const size_t head0 = static_cast<size_t>(b) * a.H +
                       static_cast<size_t>(kh) * g;
  const TQ* q = static_cast<const TQ*>(a.q) + head0 * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS)
    qs[i] = i / D < g ? to_f32(q[i]) * a.scale : 0.0f;
  __syncthreads();

  const size_t row = static_cast<size_t>(K) * D;   // elements per slot
  const size_t base = static_cast<size_t>(b) * S * row +
                      static_cast<size_t>(kh) * D;
  const TKV* kb = static_cast<const TKV*>(a.k) + base;
  const TKV* vb = static_cast<const TKV*>(a.v) + base;
  const size_t sbase = static_cast<size_t>(b) * S * K + kh;

  float m[G], l[G], acc[G][EL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < EL; ++j) acc[h][j] = 0.0f;
  }
  float* pw = ps + warp * G * 32;
  float* vw = vsc + warp * 32;

  for (int t0 = warp * 32; t0 < S; t0 += WARPS * 32) {
    const int s = t0 + lane;
    const bool in = s < S;
    float logit[G];
#pragma unroll
    for (int h = 0; h < G; ++h) logit[h] = 0.0f;
    if (in) {
      const TKV* kr = kb + static_cast<size_t>(s) * row;
      const float ksc = INT8 ? a.ks[sbase + static_cast<size_t>(s) * K]
                             : 1.0f;
#pragma unroll 4
      for (int c = 0; c < D / VEC; ++c) {
        float e[VEC];
        load_f32<TKV, VEC>(kr + c * VEC, e);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float kv = INT8 ? e[i] * ksc : e[i];
#pragma unroll
          for (int h = 0; h < G; ++h)
            logit[h] = fmaf(qs[h * D + c * VEC + i], kv, logit[h]);
        }
      }
      if (!a.valid[s]) {
#pragma unroll
        for (int h = 0; h < G; ++h) logit[h] = NEG_INF;
      }
    }

    float corr[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = in ? logit[h] : NEG_INF;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[h], mx);
      const float p = in ? expf(logit[h] - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      corr[h] = expf(m[h] - m_new);
      l[h] = l[h] * corr[h] + sum;
      m[h] = m_new;
      pw[h * 32 + lane] = p;
    }
    if (INT8)
      vw[lane] = in ? a.vs[sbase + static_cast<size_t>(s) * K] : 0.0f;
    __syncwarp();

#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int j = 0; j < EL; ++j) acc[h][j] *= corr[h];
    }
    const int n = min(32, S - t0);
    for (int t = 0; t < n; ++t) {
      float ve[EL];
      load_f32<TKV, EL>(vb + static_cast<size_t>(t0 + t) * row + lane * EL,
                        ve);
      if (INT8) {
        const float vsc_t = vw[t];
#pragma unroll
        for (int j = 0; j < EL; ++j) ve[j] = ve[j] * vsc_t;
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = pw[h * 32 + t];
#pragma unroll
        for (int j = 0; j < EL; ++j) acc[h][j] = fmaf(p, ve[j], acc[h][j]);
      }
    }
    __syncwarp();
  }

  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      mm[warp * G + h] = m[h];
      ll[warp * G + h] = l[h];
    }
  }
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int j = 0; j < EL; ++j)
      aa[(warp * G + h) * D + lane * EL + j] = acc[h][j];
  }
  __syncthreads();

  TQ* out = static_cast<TQ*>(a.out) + head0 * D;
  for (int i = threadIdx.x; i < g * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mm[w * G + h]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(mm[w * G + h] - M);
      L += ll[w * G + h] * f;
      A += aa[(w * G + h) * D + d] * f;
    }
    from_f32(A / fmaxf(L, 1e-30f), out + i);
  }
}

template <typename TQ, typename TKV, int D, int G>
int launch_g(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D, G>();
  auto kern = decode_kernel<TQ, TKV, D, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(a.K, a.B), THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV, int D>
int launch_d(const Args& a, cudaStream_t st) {
  if (a.g <= 1) return launch_g<TQ, TKV, D, 1>(a, st);
  if (a.g <= 2) return launch_g<TQ, TKV, D, 2>(a, st);
  if (a.g <= 4) return launch_g<TQ, TKV, D, 4>(a, st);
  if (a.g <= 8) return launch_g<TQ, TKV, D, 8>(a, st);
  if (a.g <= 16) return launch_g<TQ, TKV, D, 16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ, typename TKV>
int launch_t(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<TQ, TKV, 32>(a, st);
    case 64: return launch_d<TQ, TKV, 64>(a, st);
    case 128: return launch_d<TQ, TKV, 128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out all fp32 (bf16 == 0) or all bf16 (bf16 == 1).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* out, int B, int S, int H, int K,
                                       int D, float scale, int bf16,
                                       void* stream) {
  const Args a{q, k, v, nullptr, nullptr,
               static_cast<const uint8_t*>(valid), out, B, S, H, K, H / K,
               scale};
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_t<__nv_bfloat16, __nv_bfloat16>(a, D, st)
              : launch_t<float, float>(a, D, st);
}

// k_q, v_q int8; k_s, v_s fp32; q and out fp32 (q_bf16 == 0) or bf16.
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k_q, const void* v_q, const void* k_s,
    const void* v_s, const void* valid, void* out, int B, int S, int H,
    int K, int D, float scale, int q_bf16, void* stream) {
  const Args a{q, k_q, v_q, static_cast<const float*>(k_s),
               static_cast<const float*>(v_s),
               static_cast<const uint8_t*>(valid), out, B, S, H, K, H / K,
               scale};
  auto st = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_t<__nv_bfloat16, int8_t>(a, D, st)
                : launch_t<float, int8_t>(a, D, st);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
