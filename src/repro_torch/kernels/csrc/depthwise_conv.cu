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
// What bounds it on an H100.  Each output reads KH*KW int8 inputs and does
// as many multiply-adds: 9 MACs per output byte at most, far below the
// card's operations-per-byte line even on CUDA cores.  The int8 input is
// read once and the output written once, so the kernel is bound by bytes.
//
// Design.  There is no tensor-core mapping for a per-channel 3x3, so this
// runs on CUDA cores.  Channels stay on the fast axis, as in NHWC: one
// thread owns four consecutive channels of one output pixel, so a warp's
// loads of one tap are consecutive words.  With mult == 1 and CIN % 4 == 0
// the thread reads the input and the weights as char4 and writes char4 (or
// float4); otherwise it reads byte by byte and indexes the multiplier as
// o / mult, so the input is never repeated in device memory.  The SAME
// border (asymmetric (0, 1) at stride 2 on an even plane) is read as zeros
// by skipping the taps outside the plane: nothing is padded in device
// memory, unlike the TPU kernel's padded plane and 128-wide channel pad.
// The weights are a few KB and stay in L1.
#include "int8_tiles.cuh"

namespace {

using namespace int8_tiles;

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ sw, const float* __restrict__ bias,
          void* __restrict__ out, int B, int H, int W, int C, int N, int KH,
          int KW, int stride, int pad_t, int pad_l, int OH, int OW, float sx,
          float inv_out_scale, float out_qmax, int relu, int out_int8) {
  const int quads = (N + 3) / 4;
  const long long total = (long long)B * OH * OW * quads;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int o0 = static_cast<int>(idx % quads) * 4;
  long long pix = idx / quads;              // (b, oy, ox), row-major
  const int ox = static_cast<int>(pix % OW);
  const int oy = static_cast<int>((pix / OW) % OH);
  const int b = static_cast<int>(pix / ((long long)OW * OH));
  const int mult = N / C;

  int acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < KH; ++i) {
    const int iy = oy * stride - pad_t + i;
    if (iy < 0 || iy >= H) continue;
    for (int j = 0; j < KW; ++j) {
      const int ix = ox * stride - pad_l + j;
      if (ix < 0 || ix >= W) continue;
      const int8_t* xp = x + (((size_t)b * H + iy) * W + ix) * C;
      const int8_t* wp = w + (size_t)(i * KW + j) * N;
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

  const size_t base = (size_t)pix * N + o0;
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

}  // namespace

extern "C" int depthwise_conv_launch(const void* x, const void* w,
                                     const void* sw, const void* bias,
                                     void* out, int B, int H, int W, int C,
                                     int N, int KH, int KW, int stride,
                                     int pad_t, int pad_l, int OH, int OW,
                                     float sx, float inv_out_scale,
                                     float out_qmax, int relu, int out_int8,
                                     int vec, void* stream) {
  const long long total = (long long)B * OH * OW * ((N + 3) / 4);
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
