#!/usr/bin/env python3
"""Where the time of one int8 decode-attention launch goes, phase by phase.

The split-S kernel (``decode_split_kernel`` in
``src/repro_torch/kernels/csrc/decode_attention.cu``) moves about 9 KB a
block at tinyllama's decode shapes, so its time is a chain of latencies,
not bytes.  This script copies the source into ``build/``, has thread 0 of
every block record ``clock64()`` and the global timer at each phase
boundary, builds that copy with nvcc and launches it through the wrapper's
own plan (``split_plan``) at tinyllama's heads (H 32, K 4, D 64, bf16 q,
7/8 of the slots valid).  It prints, for each shape, the mean and largest
cycles of each phase over the blocks, a block's span, the kernel's span
from the first block's start to the last block's end, the start skew
(blocks of a second wave start late), the time a launch takes under CUDA
events, and the card's name, power limit and clocks.  The committed
kernel is not touched.  Needs one card and nvcc:

    python3 scripts/split_kernel_phases.py
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'src'))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models.attention import kv_quantize  # noqa: E402

SHAPES = ((8, 584), (1, 584), (8, 2048))     # (B, S)
H, K, D = 32, 4, 64
PHASES = ('set-up, copies started, q staged', 'slot tiles',
          'merge of the warps', 'cluster barrier 1',
          'merge of the blocks', 'cluster barrier 2')
STAMPS = '''
__device__ unsigned long long g_stamps[8192 * 16];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { if (threadIdx.x == 0) { \\
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + \\
                  blockIdx.x; \\
  g_stamps[blk * 16 + (i)] = clock64(); \\
  g_stamps[blk * 16 + 8 + (i)] = global_ns(); } } while (0)
'''
# (text in the kernel, the stamp that goes after it), applied in order
MARKS = (
    ('decode_split_kernel(const SplitArgs a) {\n', 0),
    ('  __syncthreads();\n\n  float m[G], l[G], acc[G][CPL];\n', 1),
    ('  __syncthreads();            // the warps\' partials overlay every '
     'buffer\n', 2),
    ('    ba[i] = A;\n  }\n', 3),
    ('  STAMP(3);\n  cluster.sync();\n', 4),
    ('      from_f32(A / fmaxf(L, 1e-30f), out + i);\n    }\n  }\n', 5),
    ('  cluster.sync();              // every block\'s partials stay until '
     'read\n', 6),
)


def instrumented_source():
    src = (_build.CSRC / 'decode_attention.cu').read_text()
    src = src.replace('namespace {\n', 'namespace {\n' + STAMPS, 1)
    for text, i in MARKS:
        if src.count(text) != 1:
            raise SystemExit(f'marker for stamp {i} not found once: {text!r}')
        src = src.replace(text, text + f'  STAMP({i});\n')
    return src + '''
extern "C" int read_stamps(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_stamps, sizeof(unsigned long long) * n));
}
'''


def build():
    out = _build.BUILD_ROOT / 'phases'
    out.mkdir(parents=True, exist_ok=True)
    (out / 'decode_phases.cu').write_text(instrumented_source())
    lib = out / 'libdecode_phases.so'
    flags = [f for f in _build.NVCC_FLAGS if f not in ('-Xptxas', '-v')]
    r = subprocess.run([_build.nvcc(), *flags, '-I', str(_build.CSRC), '-o',
                        str(lib), str(out / 'decode_phases.cu')],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return ctypes.CDLL(str(lib))


def main():
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    lib = build()
    fn = lib.decode_attention_int8_launch
    fn.argtypes, fn.restype = da._ARGTYPES_INT8, ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    g = torch.Generator(device='cuda').manual_seed(0)
    for B, S in SHAPES:
        q = torch.randn((B, H, D), generator=g, device='cuda').bfloat16()
        kq, ks = kv_quantize(torch.randn((B, S, K, D), generator=g,
                                         device='cuda'))
        vq, vs = kv_quantize(torch.randn((B, S, K, D), generator=g,
                                         device='cuda'))
        valid = torch.arange(S, device='cuda') < S * 7 // 8
        out = torch.empty_like(q)
        G = da.group_pad(H // K)
        c, spb, warps = da.split_plan(B, K, S, elem=1, D=D, G=G)
        smem = da.split_smem_bytes(warps, G, D, 1)

        def call():
            rc = fn(q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
                    vs.data_ptr(), valid.data_ptr(), out.data_ptr(), B, S, H,
                    K, D, da._scale(D), 0.0, 0.0, 1, H // K, c, spb, warps,
                    smem,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f'launch failed: {rc}')
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        want = da.decode_attention_int8_plain(q, kq, vq, ks, vs, valid)
        err = float((out.float() - want.float()).abs().max()
                    / want.float().abs().max())
        n = K * B * c
        buf = np.zeros(n * 16, np.uint64)
        if lib.read_stamps(buf.ctypes.data, n * 16):
            raise SystemExit('reading the stamps failed')
        stamps = buf.reshape(n, 16).astype(np.int64)
        cycles, ns = np.diff(stamps[:, :7], axis=1), stamps[:, 8:15]
        print(f'(B,H,K,D,S)=({B},{H},{K},{D},{S}): C={c} slots/block={spb} '
              f'warps={warps}, {n} blocks; rel_err against the plain '
              f'version {err:.2e}')
        for i, name in enumerate(PHASES):
            print(f'  {name:32s} cycles mean {cycles[:, i].mean():8.0f} '
                  f'max {cycles[:, i].max():8.0f}')
        span = ns[:, 6] - ns[:, 0]
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(50):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f'  block span ns mean {span.mean():.0f} max {span.max()}; '
              f'kernel span ns {ns[:, 6].max() - ns[:, 0].min()}; start '
              f'skew ns {ns[:, 0].max() - ns[:, 0].min()}; CUDA events '
              f'{start.elapsed_time(end) / 50 * 1e3:.1f} us a launch')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,'
                          'clocks.sm,clocks.max.sm', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip())


if __name__ == '__main__':
    main()
