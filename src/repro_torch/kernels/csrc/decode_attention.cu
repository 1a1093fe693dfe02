// One-token GQA flash-decode attention for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the TPU kernels in src/repro/kernels/decode_attention.py:
// `decode_attention` / `_decode_kernel` (a bf16 or fp32 cache) and
// `decode_attention_int8` / `_decode_kernel_int8` (an int8 cache with fp32
// scales per (token, kv-head)).  The g = H / K query heads of kv-head kh of
// batch row b attend to the S slots of the cache k, v (B, S, K, D):
//     logit[h, s] = (fp32(q[b, kh*g + h]) * D**-0.5) . fp32(k[b, s, kh])
//     with an attention softcap c (gemma2): cap * tanh(logit * fp32(1/c))
//     a masked slot (valid[s] false) gets -1e30
//     online softmax in fp32 over s, out = acc / max(l, 1e-30) in q's type
// and in the int8 variant k (v) is code * k_s[b, s, kh] in fp32 (the cap
// applies to ks[s] * (q . code)).  The softcap is the reference's
// decode_attn_reference (src/repro/models/attention.py), which its TPU
// kernel lacks; it is a runtime float (0 = off, a uniform branch), applied
// before the mask, so a masked slot still gets -1e30 and not -cap.  -1e30,
// not -inf, as on the TPU: masked terms are corrected away by
// corr = exp(m_old - m_new) once a valid slot is seen, and a row whose
// slots are all masked comes out as the mean of v over the S slots.
//
// What bounds it on an H100.  Each cache element is read once and used
// for 2*g flops (g = 8 for tinyllama), far below the card's
// operations-per-byte line, so both kernels are bound by bytes: k and v
// (and their scales), q and the output once.  At tinyllama's decode
// shapes (B = 8, S = 584, K = 4, D = 64) that is 4.8 MB in bf16, 1.4 us
// at 3.35 TB/s, and a quarter of it for the int8 cache.
//
// decode_split_kernel, one template for the three caches.  S is split
// over a thread-block cluster: the grid is (K x chunks, B, C) in clusters
// of C blocks along z, block r owning slots [r * spb, (r + 1) * spb), with
// C, spb and the warps a block from the wrapper's plan (kernels/
// decode_attention.split_plan: C = 8, 73 slots and 5 warps a block, 256
// blocks, at tinyllama's batch 8 and 584 slots, for every cache type).
// A block takes gc heads of a kv head's query group, padded to a power of
// two G, gc from the wrapper's plan (kernels/decode_attention.group_split):
// the whole group, or where G x head_dim would be too large, chunks of gc
// heads, one block column each, each chunk reading the kv head's cache
// again (recurrentgemma's MQA, 16 heads over 1 kv head at head_dim 256:
// two chunks of 8, as a <256, 16> instantiation would hold 16 x 256
// accumulators over 8 warps' registers).  Each warp
// walks 16-slot sub-tiles, two lanes a slot: they copy its k and v rows
// (and, for int8, its scales) into shared memory with 16-byte (4-byte)
// cp.async, double-buffered across tiles, the k rows swizzled against bank
// conflicts, and each sums half of its dot products.  An int8 cache folds
// its dequantization into one multiply a slot: logit = ks[s] * (q . code)
// and acc += (p * vs[s]) * code, the codes turned into fp32 four at a time
// (prmt); for a bf16 or fp32 cache that multiply is compiled out.  A k or
// v row of a 2- or 4-byte cache is 2 or 4 times as long, and so are the
// buffers: the plan caps the warps so that a block fits (an fp32 cache at
// head_dim 128 takes at most 6, at head_dim 256 3, a bf16 cache at head_dim
// 256 6).  The warps' (m, l, acc) merge in shared
// memory, then the C blocks' over distributed shared memory, each rank
// merging and writing 1/C of the outputs; a final cluster.sync() keeps
// every block's shared memory alive until its peers have read it.  Every
// slot is read, masked or not, so a row with no valid slot gives the mean
// of v.  What holds it back is latency, not bytes: a block moves 9 KB of
// an int8 cache at tinyllama's shapes (18 KB in bf16), and its time goes
// to the chain of copy, dot products, softmax, p @ v, the two merges and
// two cluster barriers (PERF.md).
#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}


constexpr int MAX_CLUSTER = 8;   // the portable cluster size

struct SplitArgs {
  const void* q;          // (B, H, D) TQ
  const void* k;          // (B, S, K, D) TKV: int8 codes, bf16 or fp32
  const void* v;
  const float* ks;        // (B, S, K) fp32 scales (int8 cache only)
  const float* vs;
  const uint8_t* valid;   // (S,) bool
  void* out;              // (B, H, D) TQ
  int B, S, H, K, g;
  int gc;                 // query heads a block takes (the plan's chunk)
  int spb;                // slots a block of the cluster owns
  float scale;            // fp32(D**-0.5)
  float cap, inv_cap;     // attention softcap and fp32(1/cap); cap 0 = off
};

// Shared memory of the split kernel for W warps (a tile of 16 * W slots),
// a query group padded to G, head_dim D and a cache of ES-byte elements, in
// bytes; the wrapper's plan (kernels/decode_attention.split_smem_bytes)
// computes the same sum.
//   k, v rows       2 buffers x [16W][D * ES] bytes each
//   q               [G][D] fp32, pre-scaled
//   block acc       [G][D] fp32 (read by the peers over DSMEM)
//   p (* v scale)   [W][G][16] fp32
//   k, v scales     2 buffers x [16W] fp32 each
//   block m, l      [G] fp32 each (read by the peers over DSMEM)
// After the slot loop the warps' acc partials ([W][G][D] fp32) overlay the
// row buffers and their (m, l) ([W][G] each) the p rows.
__host__ __device__ constexpr size_t split_smem(int W, int G, int D, int ES) {
  return 64 * static_cast<size_t>(W) * D * ES + 8 * G * D + 64 * W * G +
         256 * W + 8 * G;
}

// One 16-byte (4-byte) async copy to shared memory, or zeros without a
// read when use is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool use) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(use ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool use) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(use ? 4 : 0));
}

// Four int8 codes (one 32-bit word) to fp32 exactly: flip the sign bits
// to get code + 128 as a byte, splice each byte under the exponent of
// 2**23 (prmt) and subtract 2**23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t x, float (&f)[4]) {
  const uint32_t u = x ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7653)) - 8388736.0f;
}

// Elements 4j..4j+3 of a 16-byte chunk (its words w) to fp32: one word of
// int8 codes, two of bf16 pairs (the low half first), or word j in fp32.
template <typename TKV>
__device__ __forceinline__ void chunk4_f32(const uint32_t (&w)[4], int j,
                                           float (&f)[4]) {
  if constexpr (std::is_same_v<TKV, int8_t>) {
    i8x4_to_f32(w[j], f);
  } else if constexpr (std::is_same_v<TKV, float>) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[2 * i] = __uint_as_float(w[2 * j + i] << 16);
      f[2 * i + 1] = __uint_as_float(w[2 * j + i] & 0xffff0000u);
    }
  }
}

// Four consecutive cache elements at p (aligned to 4 elements) to fp32,
// into f[0..3].
template <typename TKV>
__device__ __forceinline__ void load4_f32(const unsigned char* p, float* f) {
  if constexpr (std::is_same_v<TKV, int8_t>) {
    float t[4];
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), t);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = t[i];
  } else if constexpr (std::is_same_v<TKV, float>) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat162float(e[i]);
  }
}

// A k row is CPR chunks of 16 bytes; chunk c sits at chunk position
// swizzle(t, c) in slot t's row, so that the 8 lanes of a 16-byte shared
// load phase (4 slots, two lanes each reading a chunk of its own half row)
// fall on 8 different bank groups.  Up to 8 chunks a row the slots of a
// phase differ in the row's start bank group too; from 16 on the rows all
// start in group 0, and the lane's half row enters the XOR as its third
// bit (c / (CPR/2) is a bit above the three the XOR touches, so each row
// stays a permutation of its chunks).
template <int CPR>
__device__ __forceinline__ int swizzle(int t, int c) {
  if constexpr (CPR <= 8) {
    return c ^ ((t / (8 / CPR)) & (CPR - 1));
  } else {
    return c ^ ((t & 3) | (((c / (CPR / 2)) & 1) << 2));
  }
}

// Block (kh * chunks + ci, b, r) of the grid (K x chunks, B, C), in
// clusters of C along z, runs the online softmax of chunk ci's heads (up to
// gc of the g heads of kv-head kh) of row b over slots [r * spb, min((r +
// 1) * spb, S)); the C ranks merge the partials.  Within
// a block each warp walks 16-slot sub-tiles of 16 * W-slot tiles.  Lane
// pair (2t, 2t+1) of a warp owns slot t of its sub-tile: each copies half
// of its k and v rows (and, for int8, one of its two scales)
// (double-buffered cp.async; a warp copies only its own sub-tile, so warp
// barriers order the copies) and sums half of the g dot products
// (ks[s] *) (q . k), one shuffle joining the halves.
// Then each lane owns CPL = max(4, D / 32) channels of D for p @ v, with
// 32 * CPL / D slot groups in a warp (one at head_dim 128 and 256).
// Up to a group of 8 and G * D = 1024, the register budget keeps two
// 8-warp blocks on an SM.
template <typename TQ, typename TKV, int D, int G>
__global__ void __launch_bounds__(THREADS, G <= 8 && G * D <= 1024 ? 2 : 1)
decode_split_kernel(const SplitArgs a) {
  constexpr bool QUANT = std::is_same_v<TKV, int8_t>;
  constexpr int ES = static_cast<int>(sizeof(TKV));
  constexpr int RB = D * ES;        // bytes a k or v row
  constexpr int CPR = RB / 16;      // 16-byte chunks a row
  constexpr int HALF = CPR / 2;     // chunks of a half row (RB >= 32)
  constexpr int EPC = 16 / ES;      // elements a chunk
  static_assert(RB >= 32 && RB % 32 == 0, "a row is whole half rows");
  constexpr int CPL = D > 128 ? D / 32 : 4;   // channels a lane in p @ v
  constexpr int LPS = D / CPL;      // lanes over one v row
  constexpr int NSG = 32 / LPS;     // slot groups of a warp in p @ v
  extern __shared__ __align__(16) unsigned char split_buf[];
  const int W = blockDim.x / 32, TS = 16 * W;
  unsigned char* kt = split_buf;                     // [2][TS][RB]
  unsigned char* vt = kt + 2 * TS * RB;              // [2][TS][RB]
  float* qs = reinterpret_cast<float*>(vt + 2 * TS * RB);   // [G][D]
  float* ba = qs + G * D;                            // [G][D]
  float* pw = ba + G * D;                            // [W][G][16]
  float* kss = pw + W * G * 16;                      // [2][TS]
  float* vss = kss + 2 * TS;                         // [2][TS]
  float* bm = vss + 2 * TS;                          // [G]
  float* bl = bm + G;                                // [G]
  float* wa = reinterpret_cast<float*>(split_buf);   // [W][G][D], after
  float* wm = pw;                                    // [W][G]  the slot
  float* wl = wm + W * G;                            // [W][G]  loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int chunks = (a.g + a.gc - 1) / a.gc;
  const int kh = blockIdx.x / chunks, ci = blockIdx.x % chunks;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = a.S, K = a.K, g = min(a.gc, a.g - ci * a.gc);
  const int lo = min(S, rank * a.spb), hi = min(S, lo + a.spb);
  const int ntiles = (hi - lo + TS - 1) / TS;
  const int t = warp * 16 + lane / 2, half = lane % 2;   // slot in the tile

  const size_t row = static_cast<size_t>(K) * RB;    // bytes a slot
  const size_t base = static_cast<size_t>(b) * S * row +
                      static_cast<size_t>(kh) * RB;
  const size_t sbase = static_cast<size_t>(b) * S * K + kh;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  // Every in-range slot is read, masked or not: a masked slot's weight
  // exp(-1e30 - m) is 0 once its block has a valid slot, and a block
  // with none gives the row the mean of v when no block has one.  Bit buf
  // of valid_bits holds the mask of this lane's slot in buffer buf, loaded
  // beside the copies so that its latency hides behind theirs.
  unsigned valid_bits = 0;
  auto copy_tile = [&](int tile, int buf) {
    const int s = lo + tile * TS + t;
    const bool in = s < hi;
    valid_bits = (valid_bits & ~(1u << buf)) |
                 (unsigned(in && a.valid[s]) << buf);
    const size_t off = in ? base + static_cast<size_t>(s) * row : 0;
    unsigned char* kd = kt + (buf * TS + t) * RB;
    unsigned char* vd = vt + (buf * TS + t) * RB;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int c = half * HALF + i;
      cp_async16(kd + swizzle<CPR>(t, c) * 16, kg + off + c * 16, in);
      cp_async16(vd + c * 16, vg + off + c * 16, in);
    }
    if constexpr (QUANT) {
      const size_t soff = in ? sbase + static_cast<size_t>(s) * K : 0;
      cp_async4((half ? vss : kss) + buf * TS + t,
                (half ? a.vs : a.ks) + soff, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (ntiles > 0) copy_tile(0, 0);

  const size_t head0 = static_cast<size_t>(b) * a.H +
                       static_cast<size_t>(kh) * a.g +
                       static_cast<size_t>(ci) * a.gc;
  const TQ* q = static_cast<const TQ*>(a.q) + head0 * D;
#pragma unroll 4
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    qs[i] = i / D < g ? to_f32(q[i]) * a.scale : 0.0f;
  __syncthreads();

  float m[G], l[G], acc[G][CPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[h][j] = 0.0f;
  }
  float* pwarp = pw + warp * G * 16;
  const int sg = lane / LPS, ch = (lane % LPS) * CPL;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int buf = tile & 1;
    const int s = lo + tile * TS + t;
    const bool in = s < hi;
    const bool vld = (valid_bits >> buf) & 1u;
    if (tile + 1 < ntiles) {
      copy_tile(tile + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();             // a warp copies its own sub-tile's rows

    // half of slot t's g dot products, joined across the lane pair
    float logit[G];
#pragma unroll
    for (int h = 0; h < G; ++h) logit[h] = 0.0f;
    const unsigned char* kr = kt + (buf * TS + t) * RB;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int c = half * HALF + i;
      const uint4 u =
          *reinterpret_cast<const uint4*>(kr + swizzle<CPR>(t, c) * 16);
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < EPC / 4; ++j) {
        float f[4];
        chunk4_f32<TKV>(words, j, f);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + h * D + c * EPC + j * 4);
          logit[h] = fmaf(qv.x, f[0], logit[h]);
          logit[h] = fmaf(qv.y, f[1], logit[h]);
          logit[h] = fmaf(qv.z, f[2], logit[h]);
          logit[h] = fmaf(qv.w, f[3], logit[h]);
        }
      }
    }
    float ksc = 1.0f, vsc = 1.0f;
    if constexpr (QUANT) {
      ksc = kss[buf * TS + t];
      vsc = vss[buf * TS + t];
    }
    float corr[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      logit[h] += __shfl_xor_sync(FULL, logit[h], 1);
      float lg = NEG_INF;
      if (vld) {
        lg = QUANT ? ksc * logit[h] : logit[h];
        if (a.cap != 0.0f) lg = a.cap * tanhf(lg * a.inv_cap);
      }
      float mx = in ? lg : NEG_INF;
#pragma unroll
      for (int o = 16; o > 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[h], mx);
      const float p = in ? expf(lg - m_new) : 0.0f;
      float sum = half ? 0.0f : p;       // each slot counted once
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      corr[h] = expf(m[h] - m_new);
      l[h] = l[h] * corr[h] + sum;
      m[h] = m_new;
      if (!half) pwarp[h * 16 + lane / 2] = QUANT ? p * vsc : p;
    }
    __syncwarp();

    // p @ v: lane (sg, ch) sums slots sg, sg + NSG, ... of the sub-tile
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[h][j] *= corr[h];
    }
    const int n = min(16, hi - (lo + tile * TS + warp * 16));
#pragma unroll
    for (int k = 0; k < 16 / NSG; ++k) {
      const int tt = sg + k * NSG;
      if (tt >= n) break;
      float f[CPL];
#pragma unroll
      for (int j = 0; j < CPL; j += 4)
        load4_f32<TKV>(vt + (buf * TS + warp * 16 + tt) * RB + (ch + j) * ES,
                       f + j);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = pwarp[h * 16 + tt];
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[h][j] = fmaf(p, f[j], acc[h][j]);
      }
    }
    __syncwarp();             // before the next copy into this buffer
  }
  __syncthreads();            // the warps' partials overlay every buffer

  // the slot groups' sums, then the warps' partials through shared memory
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1)
        acc[h][j] += __shfl_xor_sync(FULL, acc[h][j], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      wm[warp * G + h] = m[h];
      wl[warp * G + h] = l[h];
    }
  }
  if (lane < LPS) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        wa[(warp * G + h) * D + ch + j] = acc[h][j];
    }
  }
  __syncthreads();
  // the block's (m, l) and each warp's weight exp(m_w - m), once a head
  float* fwarp = kss;          // [W][G] (2 * TS >= W * G floats)
  // (the loops over the warps are unrolled to WARPS with guards, so that
  // their shared-memory loads go out together)
  if (threadIdx.x < G) {
    const int h = threadIdx.x;
    float mw[WARPS], M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = w < W ? wm[w * G + h] : NEG_INF;
      M = fmaxf(M, mw[w]);
    }
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < W) {
        const float f = expf(mw[w] - M);
        fwarp[w * G + h] = f;
        L += wl[w * G + h] * f;
      }
    }
    bm[h] = M;
    bl[h] = L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int h = i / D;
    float A = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < W) A += wa[(w * G + h) * D + i % D] * fwarp[w * G + h];
    }
    ba[i] = A;
  }
  cluster.sync();

  // The C blocks' (m, l, acc) merge over distributed shared memory, each
  // rank writing its share of the g * D outputs with all 3 * C remote
  // loads of an output in flight together.  (Rank 0 alone needed several
  // rounds of remote loads for the g * D outputs while the other ranks
  // waited at the last barrier; PERF.md has the times.)
  {
    TQ* out = static_cast<TQ*>(a.out) + head0 * D;
    const int share = (g * D + C - 1) / C;
    const int end = min(g * D, (rank + 1) * share);
    for (int i = rank * share + threadIdx.x; i < end; i += blockDim.x) {
      const int h = i / D;
      float mr[MAX_CLUSTER], lr[MAX_CLUSTER], ar[MAX_CLUSTER];
      float M = NEG_INF;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        mr[r] = r < C ? cluster.map_shared_rank(bm, r)[h] : NEG_INF;
        lr[r] = r < C ? cluster.map_shared_rank(bl, r)[h] : 0.0f;
        ar[r] = r < C ? cluster.map_shared_rank(ba, r)[i] : 0.0f;
        M = fmaxf(M, mr[r]);
      }
      float L = 0.0f, A = 0.0f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        const float f = expf(mr[r] - M);
        L += lr[r] * f;
        A += ar[r] * f;
      }
      from_f32(A / fmaxf(L, 1e-30f), out + i);
    }
  }
  cluster.sync();              // every block's partials stay until read
}

template <typename TQ, typename TKV, int D, int G>
int launch_split_g(const SplitArgs& a, int C, int W, size_t smem,
                   cudaStream_t st) {
  auto kern = decode_split_kernel<TQ, TKV, D, G>;
  if (smem < split_smem(W, G, D, static_cast<int>(sizeof(TKV))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.K * ((a.g + a.gc - 1) / a.gc), a.B, C);
  cfg.blockDim = dim3(32 * W, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Chunks of up to 16 heads, and up to 8 at head_dim 256 (gemma2 and
// gemma3 have groups of 2, recurrentgemma's 16 run as two chunks of 8).
template <typename TQ, typename TKV, int D>
int launch_split_d(const SplitArgs& a, int C, int W, size_t smem,
                   cudaStream_t st) {
  if (a.gc <= 1) return launch_split_g<TQ, TKV, D, 1>(a, C, W, smem, st);
  if (a.gc <= 2) return launch_split_g<TQ, TKV, D, 2>(a, C, W, smem, st);
  if (a.gc <= 4) return launch_split_g<TQ, TKV, D, 4>(a, C, W, smem, st);
  if (a.gc <= 8) return launch_split_g<TQ, TKV, D, 8>(a, C, W, smem, st);
  if constexpr (D <= 128) {
    if (a.gc <= 16)
      return launch_split_g<TQ, TKV, D, 16>(a, C, W, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ, typename TKV>
int launch_split_t(const SplitArgs& a, int D, int C, int W, size_t smem,
                   cudaStream_t st) {
  switch (D) {
    case 32: return launch_split_d<TQ, TKV, 32>(a, C, W, smem, st);
    case 64: return launch_split_d<TQ, TKV, 64>(a, C, W, smem, st);
    case 128: return launch_split_d<TQ, TKV, 128>(a, C, W, smem, st);
    case 256: return launch_split_d<TQ, TKV, 256>(a, C, W, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan's limits, checked before any launch.
bool plan_ok(int S, int g, int gc, int C, int spb, int W, int smem_bytes) {
  return gc >= 1 && gc <= g && C >= 1 && C <= MAX_CLUSTER && W >= 1 &&
         W <= WARPS && spb >= 1 && static_cast<long long>(C) * spb >= S &&
         smem_bytes >= 0;
}

}  // namespace

// q, k, v, out all fp32 (bf16 == 0) or all bf16 (bf16 == 1).  The plan (gc
// heads a block, C blocks of spb slots, W warps a block, smem bytes) comes
// from kernels/decode_attention.group_split and split_plan; cap 0 means no
// softcap.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* valid,
                                       void* out, int B, int S, int H, int K,
                                       int D, float scale, float cap,
                                       float inv_cap, int bf16, int gc,
                                       int C, int spb, int W, int smem_bytes,
                                       void* stream) {
  if (K < 1 || H % K || !plan_ok(S, H / K, gc, C, spb, W, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k, v, nullptr, nullptr,
                    static_cast<const uint8_t*>(valid), out, B, S, H, K,
                    H / K, gc, spb, scale, cap, inv_cap};
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  return bf16 ? launch_split_t<__nv_bfloat16, __nv_bfloat16>(a, D, C, W,
                                                             smem, st)
              : launch_split_t<float, float>(a, D, C, W, smem, st);
}

// k_q, v_q int8; k_s, v_s fp32; q and out fp32 (q_bf16 == 0) or bf16.
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k_q, const void* v_q, const void* k_s,
    const void* v_s, const void* valid, void* out, int B, int S, int H,
    int K, int D, float scale, float cap, float inv_cap, int q_bf16, int gc,
    int C, int spb, int W, int smem_bytes, void* stream) {
  if (K < 1 || H % K || !plan_ok(S, H / K, gc, C, spb, W, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitArgs a{q, k_q, v_q, static_cast<const float*>(k_s),
                    static_cast<const float*>(v_s),
                    static_cast<const uint8_t*>(valid), out, B, S, H, K,
                    H / K, gc, spb, scale, cap, inv_cap};
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  return q_bf16 ? launch_split_t<__nv_bfloat16, int8_t>(a, D, C, W, smem, st)
                : launch_split_t<float, int8_t>(a, D, C, W, smem, st);
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
