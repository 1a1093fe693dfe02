"""Atomic checkpoints of a tree of tensors (the reference's
``checkpoint/manager.py``, on the same files).

Layout:  <dir>/step_<N>/
            manifest.json      - step, leaf paths, shapes, dtypes
            proc_<i>.npz       - this process's leaf arrays

A leaf's key is its path in the tree, joined by ``/`` (dict keys, list
and tuple indices: ``params/stages/0/0/conv1/w``), in the reference's
order (dicts by sorted key), so either package reads the other's steps.
npz cannot store bfloat16 or fp8: such a leaf is stored as a raw-bit view
(uint16, uint8) with its true dtype in the manifest and viewed back on
load.  Writes go to ``step_<N>.tmp`` and are renamed only after fsync, so
a preempted save never becomes the latest step.  ``CheckpointManager``
adds asynchronous saves (the tree is copied to host memory first, so the
caller may go on changing it) and retention.

Where the port departs from the reference: ``load_checkpoint`` and
``CheckpointManager.restore_latest`` take no ``shardings=``; a leaf loads
as a CPU tensor (the caller places it), except where the leaf of
``tree_like`` is a DTensor: the full array is then placed on that
DTensor's mesh and placements, each rank keeping its own chunk (the
reference's reshard-on-load).

Sharded states (``torch.distributed``): a DTensor leaf is gathered to its
full array on every rank (a collective, so every rank saves), and only
rank 0 writes, as ``proc_0.npz``: a step holds full arrays, as the
reference's docstring says, and any mesh can read it back.  A restore
waits for this rank's write and then for every rank (a barrier), so no
rank reads a step that rank 0 has not committed.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.tree import rebuild

log = logging.getLogger('repro_torch.checkpoint')

SEP = '/'

# dtypes npz cannot store: name -> (torch dtype, the raw-bit view stored)
_BITCAST = {'bfloat16': (torch.bfloat16, torch.int16, np.uint16),
            'float8_e4m3fn': (torch.float8_e4m3fn, torch.int8, np.uint8),
            'float8_e5m2': (torch.float8_e5m2, torch.int8, np.uint8)}
_NAMES = {t: name for name, (t, _, _) in _BITCAST.items()}


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _rank() -> int:
    """This process's rank (0 outside ``torch.distributed``)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _encode(leaf):
    """A leaf as (numpy array npz can store, its dtype string), copied to
    host memory; a DTensor is gathered to its full array first."""
    if isinstance(leaf, _dtensor()):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to('cpu', copy=True)
        if t.dtype in _NAMES:
            name = _NAMES[t.dtype]
            _, signed, raw = _BITCAST[name]
            return t.view(signed).numpy().view(raw), name
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _decode(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str in _BITCAST:
        dtype, signed, _ = _BITCAST[dtype_str]
        raw = a.view(np.int16 if signed == torch.int16 else np.int8)
        return torch.from_numpy(raw).view(dtype)
    return torch.from_numpy(a)


def _paths(tree, prefix=()):
    """(path, leaf) pairs in the reference's order: dicts by sorted key,
    lists and tuples by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield SEP.join(prefix), tree


def _flatten(tree) -> dict:
    """{path: (host array, dtype string)} of every leaf."""
    return {k: _encode(v) for k, v in _paths(tree)}


def _fill(tree, leaves, prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _fill(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, (_fill(v, leaves, prefix + (str(i),))
                              for i, v in enumerate(tree)))
    return _place(leaves[SEP.join(prefix)], tree)


def _place(full: torch.Tensor, like):
    """``full`` as ``like`` holds it: a DTensor on ``like``'s mesh and
    placements (this rank's chunk of a full array every rank has read),
    else the CPU tensor itself."""
    if not isinstance(like, _dtensor()):
        return full
    from torch.distributed.tensor import distribute_tensor
    mesh = like.device_mesh
    return distribute_tensor(full.to(mesh.device_type), mesh,
                             like.placements, src_data_rank=None)


def _savez(path: str, arrays: dict):
    """``np.savez(path, **arrays)``'s file (a stored zip of ``.npy``
    members), each array's bytes handed to the zip in one call from its
    own buffer: numpy's writer copies every 16 MiB chunk twice first."""
    with zipfile.ZipFile(path, mode='w', compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, a in arrays.items():
            a = np.require(a, requirements='C')
            with zf.open(k + '.npy', 'w', force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(a))
                f.write(memoryview(a.reshape(-1)).cast('B'))


def _load_leaves(path: str, dtypes: dict) -> dict:
    """{key: tensor} of the npz at ``path``, the members read by a pool
    of threads (each with its own handle: zip reads, CRCs and copies
    release the GIL)."""
    def one(k):
        with np.load(path) as data:
            return k, _decode(data[k], dtypes[k])
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(dtypes)))) as ex:
        return dict(ex.map(one, dtypes))


def _write(ckpt_dir: str, step: int, flat: dict, process_index=0) -> str:
    final = os.path.join(ckpt_dir, f'step_{step:08d}')
    tmp = final + '.tmp'
    os.makedirs(tmp, exist_ok=True)
    _savez(os.path.join(tmp, f'proc_{process_index}.npz'),
           {k: a for k, (a, _) in flat.items()})
    manifest = {'step': step,
                'leaves': {k: {'shape': list(a.shape), 'dtype': d}
                           for k, (a, d) in flat.items()}}
    with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree, *, process_index=0):
    """Write ``tree`` (dicts, lists and tuples of tensors, DTensors or
    arrays) as committed step ``step``; returns the step directory (None
    on a rank other than 0, which only takes part in the gathers)."""
    flat = _flatten(tree)
    if _rank() != 0:
        return None
    return _write(ckpt_dir, step, flat, process_index)


def committed_steps(ckpt_dir: str) -> list[int]:
    """All committed (renamed, non-.tmp) step numbers, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split('_')[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith('step_') and not d.endswith('.tmp'))


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: int | None, tree_like, *,
                    process_index=0):
    """Restore step ``step`` (None: the newest committed one) into the
    structure of ``tree_like``, every leaf a CPU tensor, or placed as the
    DTensor leaf of ``tree_like`` is.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    d = os.path.join(ckpt_dir, f'step_{step:08d}')
    with open(os.path.join(d, 'manifest.json')) as f:
        manifest = json.load(f)
    leaves = _load_leaves(
        os.path.join(d, f'proc_{process_index}.npz'),
        {k: manifest['leaves'][k]['dtype'] for k, _ in _paths(tree_like)})
    return _fill(tree_like, leaves), step


class CheckpointManager:
    def __init__(self, ckpt_dir: str, *, keep: int = 3, async_save=True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree):
        self.wait()
        # copy to host memory synchronously (cheap), write asynchronously;
        # every rank gathers, rank 0 writes
        flat = _flatten(tree)
        if _rank() != 0:
            return

        def _run():
            _write(self.dir, step, flat)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _run()

    def _gc(self):
        for s in committed_steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f'step_{s:08d}'),
                          ignore_errors=True)

    def restore_latest(self, tree_like):
        """Restore the newest *readable* committed checkpoint.

        The tmp-rename protocol keeps a torn save from ever becoming the
        latest step, but a committed step can still rot afterwards (disk
        corruption, a truncating copy).  Rather than dying on the newest
        step's bad manifest or npz, fall back step by step to the most
        recent one that loads.  Raises FileNotFoundError only when no
        committed step is readable."""
        self.wait()
        _barrier()
        steps = committed_steps(self.dir)
        if not steps:
            raise FileNotFoundError(f'no checkpoints under {self.dir}')
        last_err = None
        for step in reversed(steps):
            try:
                return load_checkpoint(self.dir, step, tree_like)
            except (ValueError, KeyError, OSError, EOFError,
                    zipfile.BadZipFile) as e:   # ValueError covers JSON
                log.warning('checkpoint step %d unreadable (%s); '
                            'falling back', step, e)
                last_err = e
        raise FileNotFoundError(
            f'no readable checkpoint under {self.dir} '
            f'({len(steps)} committed steps, all corrupt)') from last_err
