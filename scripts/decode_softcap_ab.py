#!/usr/bin/env python3
"""Time the split decode-attention kernel of two sources in one process,
in turns: the current ``csrc/decode_attention.cu`` (with the softcap and
head_dim 256) against an earlier copy of the file given by ``--parent``
(its C entry points without the two softcap floats and the group chunk
``gc``), at tinyllama-1.1b's decode shape (B, H, K, D, S) = (8, 32, 4,
64, 584), bf16 cache and int8 cache under bf16 q, softcap off.  Both libraries are built here with the
same nvcc flags, in parallel, and launched on the same inputs; each turn
is CUDA events around 200 launches, in the order parent, current,
current, parent, repeated 5 times.  Prints each kernel's median us a
launch, both outputs' agreement, and each build's registers and spills
of the <64, 8> instantiations.

    git show <commit>:src/repro_torch/kernels/csrc/decode_attention.cu \\
        > build/parent_decode_attention.cu
    PYTHONPATH=src python3 scripts/decode_softcap_ab.py \\
        --parent build/parent_decode_attention.cu
"""
import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, 'src'))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models.attention import kv_quantize  # noqa: E402

B, H, K, D, S = 8, 32, 4, 64, 584
LAUNCHES, ROUNDS = 200, 5
_OLD = {'decode_attention_launch': [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        'decode_attention_int8_launch': [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p]}
_NEW = {'decode_attention_launch': da._ARGTYPES,
        'decode_attention_int8_launch': da._ARGTYPES_INT8}


def build(src, out):
    """Start nvcc on ``src`` into ``out``; returns the process."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    return subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, '-I',
                             str(_build.CSRC), '-o', out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def regs(log):
    """ptxas's registers and spills of the <64, 8> instantiations."""
    out, fn = [], '?'
    for line in log.splitlines():
        if 'Compiling entry' in line:
            fn = line
        elif 'Used' in line and 'Li64ELi8E' in fn:
            kind = re.sub(r".*decode_split_kernelI(.*?)Li64.*", r'\1', fn)
            out.append(f'{kind}: {line.split(":", 1)[1].strip()}')
        elif 'spill stores' in line and 'Li64ELi8E' in fn:
            out.append(f'    {line.strip()}')
    return out


def launcher(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', required=True,
                    help='an earlier decode_attention.cu')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA card')
    root = os.path.join(HERE, 'build', 'decode_ab')
    libs = {'parent': os.path.join(root, 'libparent.so'),
            'current': os.path.join(root, 'libcurrent.so')}
    procs = {'parent': build(args.parent, libs['parent']),
             'current': build(str(_build.CSRC / 'decode_attention.cu'),
                              libs['current'])}
    for tag, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(log)
        for line in regs(log):
            print(f'[{tag}] {line}')
    lib = {t: ctypes.CDLL(path) for t, path in libs.items()}
    g = torch.Generator(device='cuda').manual_seed(0)
    q = torch.randn((B, H, D), generator=g, device='cuda').bfloat16()
    k = torch.randn((B, S, K, D), generator=g, device='cuda')
    v = torch.randn((B, S, K, D), generator=g, device='cuda')
    valid = torch.arange(S, device='cuda') < S - 8
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    kb, vb = k.bfloat16(), v.bfloat16()
    st = torch.cuda.current_stream().cuda_stream
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    for kind in ('bf16', 'int8'):
        elem, G = (2 if kind == 'bf16' else 1), da.group_pad(H // K)
        c, spb, w = da.split_plan(B, K, S, elem=elem, D=D, G=G)
        smem = da.split_smem_bytes(w, G, D, elem)
        name = 'decode_attention_launch' if kind == 'bf16' else \
            'decode_attention_int8_launch'
        outs = {t: torch.empty_like(q) for t in lib}
        calls = {}
        for t in lib:
            types = (_OLD if t == 'parent' else _NEW)[name]
            fn = launcher(lib[t], name, types)
            caps = () if t == 'parent' else (0.0, 0.0)
            gc = () if t == 'parent' else (H // K,)
            ptrs = (q, kb, vb) if kind == 'bf16' else (q, kq, vq, ks, vs)
            a = [x.data_ptr() for x in ptrs] + [valid.data_ptr(),
                                                outs[t].data_ptr()]
            a += [B, S, H, K, D, da._scale(D), *caps, 1, *gc, c, spb, w,
                  smem, st]
            calls[t] = (fn, a)
        for t, (fn, a) in calls.items():
            if fn(*a):
                raise SystemExit(f'{t} launch failed')
        torch.cuda.synchronize()
        same = bool(torch.equal(outs['parent'].view(torch.int16),
                                outs['current'].view(torch.int16)))
        times = {t: [] for t in lib}
        for _ in range(ROUNDS):
            for t in ('parent', 'current', 'current', 'parent'):
                fn, a = calls[t]
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                start.record()
                for _ in range(LAUNCHES):
                    fn(*a)
                end.record()
                torch.cuda.synchronize()
                times[t].append(start.elapsed_time(end) / LAUNCHES * 1e3)
        print(f'{kind} (B,H,K,D,S)=({B},{H},{K},{D},{S}) plan C={c} '
              f'spb={spb} warps={w}: outputs bit-equal {same}; us a launch '
              + ', '.join(f'{t} median {statistics.median(v):.3f} '
                          f'(min {min(v):.3f}, max {max(v):.3f})'
                          for t, v in times.items()))


if __name__ == '__main__':
    main()
