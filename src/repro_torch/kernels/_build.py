"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<hash>/
lib<name>.so`` at the repository root on first use, keyed by a hash of
the flags and of every file under ``csrc/`` (sources and the headers
they share), so an edit rebuilds and an unchanged tree loads at once.
Sources have a plain C interface (no PyTorch headers), which keeps a
build to seconds.  All sources are compiled in parallel, one nvcc
process each.  The ptxas report (registers, shared
memory, spills) is kept beside each library as ``lib<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[3] / 'build' / \
    'repro_torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc; raises when the toolkit is missing."""
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                           'source on first use and need the CUDA toolkit')
    return path


def _lib_path(name: str) -> Path:
    """Library path keyed by the flags and by every file under ``csrc/``
    (a source includes shared headers, so an edit to any of them must
    rebuild every library)."""
    h = hashlib.sha256(name.encode() + b'\0' + ' '.join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob('*') if p.is_file()):
        h.update(b'\0' + path.relative_to(CSRC).as_posix().encode() + b'\0')
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f'lib{name}.so'


def build_all() -> dict[str, dict]:
    """Compile every source that has no library yet, all nvcc processes
    started together.  Returns ``{name: {'path', 'log', 'seconds',
    'built'}}``; raises with nvcc's output when a build fails."""
    names = sorted(p.stem for p in CSRC.glob('*.cu'))
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {'path': path, 'built': False, 'seconds': 0.0,
                         'log': path.with_suffix('.log').read_text()}
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f'{path.stem}.{os.getpid()}.tmp.so')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {name}.cu '
                               f'(rc={proc.returncode}):\n{log}')
        path.with_suffix('.log').write_text(log)
        os.replace(tmp, path)            # atomic: concurrent builders agree
        out[name] = {'path': path, 'built': True, 'log': log,
                     'seconds': time.perf_counter() - t0}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(kernel: str, device, want) -> None:
    """Raise ValueError unless every ``(tensor, dtype, shape or None)`` of
    ``want`` lies on ``device``, is contiguous and has that dtype and shape:
    the C entry points take raw pointers and trust all four."""
    for t, dtype, shape in want:
        if t.device != device:
            raise ValueError(f'{kernel}: operands on different devices')
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{kernel}: expected contiguous {dtype}, got '
                             f'{t.dtype}')
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f'{kernel}: expected shape {shape}, got '
                             f'{tuple(t.shape)}')


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernels_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')
