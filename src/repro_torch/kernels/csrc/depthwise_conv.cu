// Int8 depthwise conv for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel in src/repro/kernels/depthwise_conv.py
// (`depthwise_conv` / `_dw_kernel`): a direct SAME conv with per-group
// input depth 1.  For output pixel (b, oy, ox) and channel o,
//     acc = sum over taps (i, j) of x[b, iy, ix, o / mult] * w[i, j, 0, o]
// in int32, mult = COUT / CIN, then the epilogue shared with quant_matmul
// (int8_tiles.cuh): float(acc) * (sx * sw[o]) (+ bias[o]) (ReLU), and with
// an int8 output the static requantize on the reciprocal of out_scale.
//
// What bounds it on an H100.  Bytes: the int8 input is read once and the
// output written once, 9 multiply-adds an output at most.  At stage 0 of
// mobilenetv2-cifar (32 x 32 x 32 x 96) the 6.3 MB move in 1.9 us at
// 3.35 TB/s, and the 28 M multiply-adds, one int32 IMAD each, need about
// as long: an SM issues 64 IMAD lanes a clock (half its FFMA rate), 1.7-1.9
// us over 132 SMs.  So the instructions an output costs decide how close
// to the byte bound the kernel can come.  There is no tensor-core mapping
// for a per-channel 3x3: this runs on CUDA cores.
//
// Two kernels, chosen by the wrapper (kernels/depthwise_conv.py, dw_plan
// and dw_route):
//
// dw_tile_kernel (3x3, stride 1 or 2, CIN and COUT multiples of 16, mult 1
// or 2, x, w and out 16-byte aligned: every mobilenetv2-cifar layer).  A
// block owns one image, a band of output rows and a slice of whole 16-byte
// output-channel groups (the plan's `slice`, at most 128 channels).  One
// thread issues a single 4-D TMA load of the band's halo tile -- its input
// rows plus the 2 halo rows, the full width plus the halo columns, its
// input channels -- from a tensor map over (B, H, W, CIN); the hardware's
// out-of-bounds zero fill at negative and past-the-end coordinates is the
// SAME padding, the asymmetric (0, 1) at stride 2 included.  Before it
// waits on the tile every thread loads its weights, sx * sw and bias into
// registers.  A thread owns one 16-byte group of 16 output channels of a
// run of `cols` output columns of one row, and slides a 3-column window of
// 16-byte loads (8-byte with mult 2) along the run, so at stride 1 each
// input column of the band is read from shared memory once a run.  All
// index math is 32-bit (the launcher checks every offset < 2^31).
//   Multiply-adds: the three taps of a kernel row, one channel, are packed
// into one word by a byte transpose (il, then right or left: 6 prmt for
// four channels) and summed by __dp4a against the row's packed weights
// (byte 3 zero).  At stride 1 the interleave of a window's last two
// columns is the next output's first two, so every other step reuses it:
// 3 dp4a and 3.75 prmt an output (4.5 at stride 2, half of that with
// mult 2), against 9 IMAD and 18 byte extractions unpacked (2.4x slower
// at stage 0: scripts/dw_plan_sweep.py builds that variant in its own copy
// of this file and times the two side by side).  Epilogue: the
// accumulators start at the bits of 1.5 * 2^23, so float(acc) is exact
// in one subtraction (|acc| <= 9 * 128 * 128 < 2^22; no quarter-rate I2F),
// then the scale and bias as in int8_tiles.cuh; for int8 the clip comes
// before the rounding (the same code: the bounds are whole numbers), takes
// a ReLU as its lower bound, and the rounding is the low byte of the bits
// of (v + 1.5 * 2^23): 7 ops an output and 3 prmt a word of four codes, no
// conversion unit.  Stores: one 16-byte int8 store, or four float4, an
// output pixel.
//   Bank conflicts: the tile is dense, as TMA writes it, (row, column,
// channel) with the slice's channels innermost, and exactly as wide as
// the runs reach.  Lanes are ordered group first, then row, then run, so
// the eight lanes of a 16-byte phase read neighbouring groups of one pixel
// and, where a slice is under 128 channels, the same column in the next
// band rows, which may share banks (2-way at mobilenetv2's shapes).  A box
// widened to a row pitch free of conflicts was no faster at any
// mobilenetv2-cifar shape (the sweep's box widths, PERF.md): three 16-byte
// loads a 16 outputs leave the shared-memory pipe idle most of the time.
//   Registers (ptxas -v on sm_90a, nvcc 12.8, printed by chip_smoke.py
// phase 1), no spill in any of the 8 instantiations (mult 1/2 x stride
// 1/2 x runs of 2/4): 156-167 at mult 1 (48 packed weights, 32 scales and
// biases, 36-48 window words, 24 interleaves and 16 accumulators a
// thread), 127-136 at mult 2 (the sweep's IMAD copy: 174-240).  So two
// 192-thread blocks fit an SM.
//   Loading each tile row with its own TMA load and barrier, so that a
// band's first output rows start while the rest are in flight, was slower
// at every mobilenetv2 shape (PERF.md, Findings): the small loads queue.
//
// dw_kernel (the rest: odd channel counts, other kernel sizes and
// multipliers, misaligned operands).  One thread per four channels of one
// output pixel, taps outside the plane skipped, char4 loads and stores
// where mult == 1 and CIN % 4 == 0, bytes and an o / mult index otherwise.
#include <cuda.h>

#include "int8_tiles.cuh"
#include "wgmma_tma.cuh"

namespace {

using namespace int8_tiles;
using wgmma_tma::mbar_expect_tx;
using wgmma_tma::mbar_init;
using wgmma_tma::mbar_wait;
using wgmma_tma::smem_u32;

constexpr int THREADS = 256;          // dw_kernel
constexpr int TILE_MAX_THREADS = 256;  // dw_tile_kernel (the plan's limit)
constexpr int TILE_MAX_GROUPS = 8;     // 16-byte groups a slice
constexpr int TILE_ALIGN = 128;        // TMA destination alignment
constexpr int MAX_BOX = 256;           // a TMA box dimension

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ sw, const float* __restrict__ bias,
          void* __restrict__ out, int B, int H, int W, int C, int N, int KH,
          int KW, int stride, int pad_t, int pad_l, int OH, int OW, float sx,
          float inv_out_scale, float out_qmax, int relu, int out_int8) {
  const int quads = (N + 3) / 4;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * OH * OW * quads) return;   // < 2^31: the launcher checks
  const int o0 = (idx % quads) * 4;
  const int pix = idx / quads;              // (b, oy, ox), row-major
  const int ox = pix % OW;
  const int oy = (pix / OW) % OH;
  const int b = pix / (OW * OH);
  const int mult = N / C;

  int acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < KH; ++i) {
    const int iy = oy * stride - pad_t + i;
    if (iy < 0 || iy >= H) continue;
    for (int j = 0; j < KW; ++j) {
      const int ix = ox * stride - pad_l + j;
      if (ix < 0 || ix >= W) continue;
      const int8_t* xp = x + ((b * H + iy) * W + ix) * C;
      const int8_t* wp = w + (i * KW + j) * N;
      if (VEC) {
        const char4 xv = *reinterpret_cast<const char4*>(xp + o0);
        const char4 wv = *reinterpret_cast<const char4*>(wp + o0);
        acc[0] += int(xv.x) * int(wv.x);
        acc[1] += int(xv.y) * int(wv.y);
        acc[2] += int(xv.z) * int(wv.z);
        acc[3] += int(xv.w) * int(wv.w);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int o = o0 + k;
          if (o < N) acc[k] += int(xp[o / mult]) * int(wp[o]);
        }
      }
    }
  }

  const int base = pix * N + o0;
  float y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = o0 + k;
    y[k] = o < N ? dequant(acc[k], __fmul_rn(sx, sw[o]), bias, o, relu)
                 : 0.0f;
  }
  if (out_int8) {
    int8_t q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = requant(y[k], inv_out_scale, out_qmax);
    int8_t* op = static_cast<int8_t*>(out) + base;
    if (VEC) {
      *reinterpret_cast<char4*>(op) = make_char4(q[0], q[1], q[2], q[3]);
    } else {
      for (int k = 0; k < 4 && o0 + k < N; ++k) op[k] = q[k];
    }
  } else {
    float* op = static_cast<float*>(out) + base;
    if (VEC) {
      *reinterpret_cast<float4*>(op) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
      for (int k = 0; k < 4 && o0 + k < N; ++k) op[k] = y[k];
    }
  }
}

// ------------------------------------------------------------ the tile route

struct TileArgs {
  const int8_t* w;      // (3, 3, 1, N)
  const float* sw;      // (N,)
  const float* bias;    // (N,) or null
  void* out;            // (B, OH, OW, N) int8 or fp32
  int N, OH, OW, pad_t, pad_l;
  int groups, rows, box_w, box_h;   // the plan: 16-byte groups a slice, ...
  float sx, inv_out_scale, out_qmax;
  int relu, out_int8;
};

// Bytes of shared memory the tile route's layout needs (dw_smem_bytes in
// kernels/depthwise_conv.py): alignment slack, the tile, the mbarrier.
__host__ __device__ constexpr int tile_smem(int box_c, int box_w, int box_h) {
  return TILE_ALIGN + (box_c * box_w * box_h + 15) / 16 * 16 + 16;
}

// One 4-D TMA box (coordinates innermost first) into shared memory,
// completing on `bar`; coordinates outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The 16 / MULT input bytes of one pixel that a thread's 16 output
// channels read (output channel k reads input byte k / MULT).
template <int MULT>
struct Pix {
  uint32_t v[4 / MULT];
  __device__ __forceinline__ void load(const unsigned char* p) {
    if constexpr (MULT == 1) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      v[0] = q.x;
      v[1] = q.y;
    }
  }
};

// The byte transpose that packs the three taps of a kernel row, one channel
// to a word, for __dp4a.  a, b, c are the row's three input columns, four
// channels a word; il(a, b) interleaves two columns (2 prmt), and
// right(il(a, b), c) or left(a, il(b, c)) gives p[k] = [a.k, b.k, c.k, *]
// for the four channels (4 prmt).  Byte 3 meets a zero weight.
struct Il {
  uint32_t lo, hi;    // a0 b0 a1 b1, a2 b2 a3 b3
};

__device__ __forceinline__ Il il(uint32_t a, uint32_t b) {
  return {__byte_perm(a, b, 0x5140), __byte_perm(a, b, 0x7362)};
}

__device__ __forceinline__ void right(const Il& ab, uint32_t c,
                                      uint32_t (&p)[4]) {
  p[0] = __byte_perm(ab.lo, c, 0x0410);
  p[1] = __byte_perm(ab.lo, c, 0x0532);
  p[2] = __byte_perm(ab.hi, c, 0x0610);
  p[3] = __byte_perm(ab.hi, c, 0x0732);
}

__device__ __forceinline__ void left(uint32_t a, const Il& bc,
                                     uint32_t (&p)[4]) {
  p[0] = __byte_perm(a, bc.lo, 0x0540);
  p[1] = __byte_perm(a, bc.lo, 0x0761);
  p[2] = __byte_perm(a, bc.hi, 0x0542);
  p[3] = __byte_perm(a, bc.hi, 0x0763);
}

// 1.5 * 2^23: an int32 acc with |acc| < 2^22 added to its bits is the
// float 1.5 * 2^23 + acc exactly, so float(acc) is one subtraction away;
// a float v with |v| <= 2^22 added to it holds rint(v) (half to even) in
// its low bits.
constexpr int MAGIC_BITS = 0x4B400000;
constexpr float MAGIC = 12582912.0f;

template <int MULT, int S, int RC>
__global__ void __launch_bounds__(TILE_MAX_THREADS)
dw_tile_kernel(const __grid_constant__ CUtensorMap tx, const TileArgs a) {
  extern __shared__ __align__(16) unsigned char dw_raw[];
  unsigned char* tile =
      dw_raw + ((TILE_ALIGN - (smem_u32(dw_raw) & (TILE_ALIGN - 1))) &
                (TILE_ALIGN - 1));
  const int gs = a.groups;
  const int cs = gs * 16 / MULT;                  // tile bytes a pixel
  const int tile_bytes = cs * a.box_w * a.box_h;
  const uint32_t bar = smem_u32(tile + (tile_bytes + 15) / 16 * 16);
  const int oy0 = blockIdx.y * a.rows;
  const int b = blockIdx.z;
  const int t = threadIdx.x;

  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, tile_bytes);
    tma_load_4d(smem_u32(tile), &tx, bar, blockIdx.x * cs, -a.pad_l,
                oy0 * S - a.pad_t, b);
  }
  __syncthreads();             // the barrier is initialised before any wait

  const int g = t % gs;
  const int y = (t / gs) % a.rows;
  const int ox0 = t / (gs * a.rows) * RC;
  const int o0 = (blockIdx.x * gs + g) * 16;
  const int oy = oy0 + y;
  // Thread 0 (group 0 of the band's first row) always stays, so the block
  // lives until the tile has landed.
  if (o0 >= a.N || oy >= a.OH) return;

  // Before the wait: the 9 taps packed per kernel row and channel
  // ([w(i,0), w(i,1), w(i,2), 0], 48 words), sx * sw and bias.
  uint32_t wp[3][16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    uint4 tap[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      tap[j] = *reinterpret_cast<const uint4*>(a.w + (i * 3 + j) * a.N + o0);
    const uint32_t t0[4] = {tap[0].x, tap[0].y, tap[0].z, tap[0].w};
    const uint32_t t1[4] = {tap[1].x, tap[1].y, tap[1].z, tap[1].w};
    const uint32_t t2[4] = {tap[2].x, tap[2].y, tap[2].z, tap[2].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t p[4];
      right(il(t0[q], t1[q]), t2[q], p);
#pragma unroll
      for (int m = 0; m < 4; ++m) wp[i][4 * q + m] = p[m] & 0x00FFFFFFu;
    }
  }
  float sc[16], bi[16];
  const bool has_bias = a.bias != nullptr;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    sc[k] = __fmul_rn(a.sx, a.sw[o0 + k]);
    bi[k] = has_bias ? a.bias[o0 + k] : 0.0f;
  }
  // int8 output: ReLU folds into the clip's lower bound (the reciprocal
  // scale is positive, so max(y, 0) * inv rounds to the same code)
  const float lo = a.relu ? 0.0f : -a.out_qmax - 1.0f, hi = a.out_qmax;

  mbar_wait(bar, 0);

  // Tile row y*S + i, column ox*S + j (ox relative to the run's start)
  // holds input row oy*S - pad_t + i, column ox*S - pad_l + j.
  const int rowb = a.box_w * cs;
  const unsigned char* src =
      tile + (y * S * a.box_w + ox0 * S) * cs + g * (16 / MULT);
  int out_off = ((b * a.OH + oy) * a.OW + ox0) * a.N + o0;

  Pix<MULT> win[3][3];
  Il ils[3][4 / MULT];        // a row's interleaved column pair
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) win[i][j].load(src + i * rowb + j * cs);

#pragma unroll
  for (int k = 0; k < RC; ++k) {
    Pix<MULT> nxt[3][S];      // the next output's new columns, in flight
    if (k + 1 < RC) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int s = 0; s < S; ++s)
          nxt[i][s].load(src + i * rowb + (k * S + 3 + s) * cs);
    }

    int acc[16];     // offset by MAGIC_BITS (exact_float below)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = MAGIC_BITS;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int q = 0; q < 4 / MULT; ++q) {
        // At stride 1 the interleave of the window's last two columns is
        // the next output's first two: every other step reuses it.
        uint32_t p[4];
        if (S == 1 && k % 2 == 1) {
          ils[i][q] = il(win[i][1].v[q], win[i][2].v[q]);
          left(win[i][0].v[q], ils[i][q], p);
        } else {
          if (S != 1 || k == 0)
            ils[i][q] = il(win[i][0].v[q], win[i][1].v[q]);
          right(ils[i][q], win[i][2].v[q], p);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int u = 0; u < MULT; ++u) {
            const int c = (4 * q + m) * MULT + u;
            acc[c] = __dp4a(static_cast<int>(p[m]),
                            static_cast<int>(wp[i][c]), acc[c]);
          }
      }
    }

    if (ox0 + k < a.OW) {
      float yv[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float v = __fmul_rn(__fsub_rn(__int_as_float(acc[c]), MAGIC), sc[c]);
        if (has_bias) v = __fadd_rn(v, bi[c]);
        yv[c] = v;
      }
      if (a.out_int8) {
        // rint(clip(v)) == clip(rint(v)) for integer bounds; the low byte
        // of the bits of (v + MAGIC) is rint(v)
        uint32_t qb[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float v =
              fminf(fmaxf(__fmul_rn(yv[c], a.inv_out_scale), lo), hi);
          qb[c] = static_cast<uint32_t>(__float_as_int(__fadd_rn(v, MAGIC)));
        }
        uint32_t word[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          word[m] = __byte_perm(__byte_perm(qb[4 * m], qb[4 * m + 1], 0x0040),
                                __byte_perm(qb[4 * m + 2], qb[4 * m + 3],
                                            0x0040),
                                0x5410);
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(a.out) + out_off) =
            make_uint4(word[0], word[1], word[2], word[3]);
      } else {
        if (a.relu) {
#pragma unroll
          for (int c = 0; c < 16; ++c) yv[c] = fmaxf(yv[c], 0.0f);
        }
        float4* op = reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                               out_off);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          op[m] = make_float4(yv[4 * m], yv[4 * m + 1], yv[4 * m + 2],
                              yv[4 * m + 3]);
      }
    }
    out_off += a.N;

    if (k + 1 < RC) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if constexpr (S == 1) {
          win[i][0] = win[i][1];
          win[i][1] = win[i][2];
          win[i][2] = nxt[i][0];
        } else {
          win[i][0] = win[i][2];
          win[i][1] = nxt[i][0];
          win[i][2] = nxt[i][1];
        }
      }
    }
  }
}

// (B, H, W, C) int8 NHWC as a 4-D tensor map (innermost first), read in
// boxes of (box_c, box_w, box_h, 1) with no swizzle; the hardware fills
// out-of-range parts with zeros.
bool encode_nhwc(CUtensorMap* map, const void* x, int B, int H, int W, int C,
                 int box_c, int box_w, int box_h) {
  wgmma_tma::EncodeTiled fn = wgmma_tma::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
      static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C),
                                 static_cast<cuuint64_t>(W) * C,
                                 static_cast<cuuint64_t>(H) * W * C};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MULT, int S, int RC>
int launch_tile(const CUtensorMap& map, const TileArgs& a, dim3 grid,
                int threads, size_t smem, cudaStream_t st) {
  static size_t allowed[64] = {};      // the opt-in limit set, per device
  auto kern = dw_tile_kernel<MULT, S, RC>;
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
  kern<<<grid, threads, smem, st>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

template <int MULT, int S>
int launch_rc(int rc, const CUtensorMap& map, const TileArgs& a, dim3 grid,
              int threads, size_t smem, cudaStream_t st) {
  switch (rc) {
    case 2:
      return launch_tile<MULT, S, 2>(map, a, grid, threads, smem, st);
    case 4:
      return launch_tile<MULT, S, 4>(map, a, grid, threads, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int MULT>
int launch_stride(int stride, int rc, const CUtensorMap& map,
                  const TileArgs& a, dim3 grid, int threads, size_t smem,
                  cudaStream_t st) {
  return stride == 1 ? launch_rc<MULT, 1>(rc, map, a, grid, threads, smem, st)
                     : launch_rc<MULT, 2>(rc, map, a, grid, threads, smem, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The general kernel: any depthwise shape; vec: mult == 1, CIN % 4 == 0
// and x, w 4-byte aligned.
extern "C" int depthwise_conv_launch(const void* x, const void* w,
                                     const void* sw, const void* bias,
                                     void* out, int B, int H, int W, int C,
                                     int N, int KH, int KW, int stride,
                                     int pad_t, int pad_l, int OH, int OW,
                                     float sx, float inv_out_scale,
                                     float out_qmax, int relu, int out_int8,
                                     int vec, void* stream) {
  const long long total = (long long)B * OH * OW * ((N + 3) / 4);
  if (total >= (1LL << 31) || (long long)B * H * W * C >= (1LL << 31) ||
      (long long)B * OH * OW * N >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) /
                                                THREADS);
  auto st = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto swp = static_cast<const float*>(sw);
  auto bp = static_cast<const float*>(bias);
  if (vec)
    dw_kernel<true><<<blocks, THREADS, 0, st>>>(
        xp, wp, swp, bp, out, B, H, W, C, N, KH, KW, stride, pad_t, pad_l,
        OH, OW, sx, inv_out_scale, out_qmax, relu, out_int8);
  else
    dw_kernel<false><<<blocks, THREADS, 0, st>>>(
        xp, wp, swp, bp, out, B, H, W, C, N, KH, KW, stride, pad_t, pad_l,
        OH, OW, sx, inv_out_scale, out_qmax, relu, out_int8);
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel: 3x3, stride 1 or 2, C and N multiples of 16, N = C or
// 2C, x, w and out 16-byte aligned; the plan (groups a slice, output rows
// a band, output columns a run, threads, the box's columns and rows, the
// shared memory bytes) from kernels/depthwise_conv.dw_plan.
// Refuses (cudaErrorInvalidValue) anything else, a plan whose threads do
// not cover the band or whose box or shared memory is smaller than the
// kernel's layout.
extern "C" int depthwise_conv_tile_launch(
    const void* x, const void* w, const void* sw, const void* bias,
    void* out, int B, int H, int W, int C, int N, int stride, int pad_t,
    int pad_l, int OH, int OW, float sx, float inv_out_scale, float out_qmax,
    int relu, int out_int8, int groups, int rows, int cols, int threads,
    int box_w, int box_h, int smem_bytes, void* stream) {
  const int mult = C > 0 ? N / C : 0;
  const int runs = cols > 0 ? (OW + cols - 1) / cols : 0;
  const bool bad =
      C <= 0 || C % 16 != 0 || N % 16 != 0 || N != mult * C ||
      (mult != 1 && mult != 2) || (stride != 1 && stride != 2) ||
      groups < 1 || groups > TILE_MAX_GROUPS || groups % mult != 0 ||
      rows < 1 || (cols != 2 && cols != 4) || OH < 1 ||
      OW < 1 || B < 1 || B > 65535 || threads != groups * rows * runs ||
      threads > TILE_MAX_THREADS || box_h != (rows - 1) * stride + 3 ||
      box_w < (runs * cols - 1) * stride + 3 || box_w > MAX_BOX ||
      box_h > MAX_BOX || (OH + rows - 1) / rows > 65535 ||
      smem_bytes < tile_smem(groups * 16 / mult, box_w, box_h) ||
      !aligned16(x) || !aligned16(w) || !aligned16(out) ||
      (long long)B * H * W * C >= (1LL << 31) ||
      (long long)B * OH * OW * N >= (1LL << 31) ||
      (out_int8 && (out_qmax != floorf(out_qmax) || out_qmax < 0.0f ||
                    out_qmax > 127.0f || !(inv_out_scale > 0.0f)));
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!encode_nhwc(&map, x, B, H, W, C, groups * 16 / mult, box_w, box_h))
    return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs a{static_cast<const int8_t*>(w),
                   static_cast<const float*>(sw),
                   static_cast<const float*>(bias),
                   out,
                   N,
                   OH,
                   OW,
                   pad_t,
                   pad_l,
                   groups,
                   rows,
                   box_w,
                   box_h,
                   sx,
                   inv_out_scale,
                   out_qmax,
                   relu,
                   out_int8};
  const dim3 grid((N + 16 * groups - 1) / (16 * groups),
                  (OH + rows - 1) / rows, B);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  return mult == 1
             ? launch_stride<1>(stride, cols, map, a, grid, threads, smem, st)
             : launch_stride<2>(stride, cols, map, a, grid, threads, smem, st);
}
