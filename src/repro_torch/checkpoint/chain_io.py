"""ChainState persistence (the reference's ``checkpoint/chain_io.py``, on
the same files): the compression chain survives preemption, and a chain
either package compressed loads into the other.

The params tree (low-rank ``{'u','v'}`` pairs and pruned shapes
included) goes through :func:`~repro_torch.checkpoint.manager.
save_checkpoint`; what the arrays cannot carry rides in a JSON sidecar per
step: the cfg dataclass (class path and fields, tuples restored on load),
the chain scalars, ``exit_probs``, the per-pass ``history``, the tree's
structure (pruned and factored trees have shapes the caller cannot
rebuild) and the key.

``step`` is the number of passes applied (0 = the trained baseline),
which lets ``Pipeline.run(checkpoint_dir=...)`` resume mid-chain.  The
family is not stored: it holds the data source, and the caller passes it
to :func:`load_chain_state`, whose ``device`` the params are placed on.

Where the port departs from the reference:

* The key.  The reference stores ``jax.random.key_data(key)``, two uint32
  words (hi, lo); the port's key is an integer seed.  One map serves
  both ways: the seed is the 64-bit integer ``hi << 32 | lo``, stored as
  ``(seed >> 32, seed & 0xffffffff)``.  ``jax.random.key(s)`` has the key
  data ``(0, s)`` for a seed ``s < 2**32``, so a reference chain started
  from ``key(s)`` and a port chain started from ``s`` store the same
  baseline key.
* The cfg class.  A path under ``repro.`` (the reference's) is read as
  the same path under ``repro_torch.``, by string; the port imports
  nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os

import numpy as np

from repro_torch.checkpoint.manager import (latest_step, load_checkpoint,
                                            save_checkpoint)


def key_data(seed: int) -> np.ndarray:
    """The port's seed as the reference's key data: uint32 (hi, lo)."""
    return np.array([seed >> 32, seed & 0xffffffff], np.uint32)


def seed_of(data) -> int:
    """The reference's key data (uint32 (hi, lo)) as the port's seed."""
    hi, lo = (int(v) for v in np.asarray(data, np.uint32).reshape(2))
    return hi << 32 | lo


def _spec(tree):
    """JSON-able structure descriptor of a tree of dict/list/tuple."""
    if isinstance(tree, dict):
        return {'kind': 'dict', 'items': {k: _spec(v) for k, v in
                                          tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {'kind': type(tree).__name__,
                'items': [_spec(v) for v in tree]}
    return None                                   # leaf


def _skeleton(spec):
    """A same-structure tree with placeholder leaves (the ``tree_like``
    that ``load_checkpoint`` keys its arrays by)."""
    if spec is None:
        return None
    if spec['kind'] == 'dict':
        return {k: _skeleton(v) for k, v in spec['items'].items()}
    seq = [_skeleton(v) for v in spec['items']]
    return tuple(seq) if spec['kind'] == 'tuple' else seq


def _tuplify(v):
    return tuple(_tuplify(x) for x in v) if isinstance(v, list) else v


def _meta_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f'chain_{step:08d}.json')


def _cfg_class(path: str):
    """The cfg class at ``module:qualname``; a reference path (``repro.``)
    names the port's class at the same path under ``repro_torch.``."""
    mod, _, qual = path.partition(':')
    if mod == 'repro' or mod.startswith('repro.'):
        mod = 'repro_torch' + mod[len('repro'):]
    cls = importlib.import_module(mod)
    for part in qual.split('.'):
        cls = getattr(cls, part)
    return cls


def save_chain_state(ckpt_dir: str, state, step: int = 0) -> str:
    """Persist a ChainState as checkpoint ``step`` (atomic; see manager).

    The JSON sidecar is committed BEFORE the npz step dir: ``latest_step``
    only sees committed step dirs, so a crash between the two leaves the
    previous step fully loadable (an orphaned sidecar is harmless and is
    overwritten by the next save of that step)."""
    tree = {'params': state.params, 'key': key_data(state.key)}
    os.makedirs(ckpt_dir, exist_ok=True)
    cfg = state.cfg
    meta = {
        'step': step,
        'cfg_class': f'{type(cfg).__module__}:{type(cfg).__qualname__}',
        'cfg': dataclasses.asdict(cfg),
        'spec': _spec(tree),
        'scalars': {k: getattr(state, k) for k in
                    ('base_bitops', 'base_bits', 'prune_scale',
                     'lowrank_scale', 'exit_threshold', 'dyn_accuracy')},
        'exit_probs': (None if state.exit_probs is None
                       else {str(k): v for k, v in state.exit_probs.items()}),
        'history': state.history,
    }
    tmp = _meta_path(ckpt_dir, step) + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, _meta_path(ckpt_dir, step))
    return save_checkpoint(ckpt_dir, step, tree)


def load_chain_state(ckpt_dir: str, family, step: int | None = None):
    """Restore ``(ChainState, step)`` saved by :func:`save_chain_state`
    (of either package), the params on ``family.device``.

    ``step=None`` loads the newest committed step.  ``family`` is the live
    family adapter (data source and hooks) the state should run on."""
    from repro_torch.core.export import to_device
    from repro_torch.core.passes import ChainState
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no chain checkpoints under {ckpt_dir}')
    with open(_meta_path(ckpt_dir, step)) as f:
        meta = json.load(f)
    cfg = _cfg_class(meta['cfg_class'])(
        **{k: _tuplify(v) for k, v in meta['cfg'].items()})
    tree, _ = load_checkpoint(ckpt_dir, step, _skeleton(meta['spec']))
    exit_probs = meta['exit_probs']
    if exit_probs is not None:
        exit_probs = {int(k): v for k, v in exit_probs.items()}
    state = ChainState(family=family, cfg=cfg,
                       params=to_device(tree['params'], family.device),
                       key=seed_of(tree['key'].numpy()),
                       exit_probs=exit_probs, history=meta['history'],
                       **meta['scalars'])
    return state, step
