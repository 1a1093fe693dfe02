"""The port's checkpoints (``checkpoint/manager.py``, ``chain_io.py``)
against the JAX package's, on the same files: a chain state either
package writes loads into the other bit for bit (cfg class, scalars,
``exit_probs``, history, key), plus the port's own atomicity and
recovery contracts."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.chain_io import load_chain_state as j_load_chain
from repro.checkpoint.chain_io import save_chain_state as j_save_chain
from repro.checkpoint.manager import load_checkpoint as j_load_checkpoint
from repro.configs.cnn import RESNET8_CIFAR as J_RESNET8
from repro.core.family import CNNFamily as JFamily
from repro.core.passes import ChainState as JState
from repro.data import SyntheticImages as JImages
from repro_torch.checkpoint import (CheckpointManager, committed_steps,
                                    latest_step, load_chain_state,
                                    load_checkpoint, save_chain_state,
                                    save_checkpoint)
from repro_torch.checkpoint.chain_io import key_data, seed_of
from repro_torch.configs.cnn import CNNConfig
from repro_torch.core.family import CNNFamily
from repro_torch.core.passes import ChainState
from repro_torch.data import SyntheticImages
from repro_torch.interop import to_numpy
from repro_torch.tree import tree_leaves

CPU_FAMILY = CNNFamily(None, device='cpu')

HISTORY = [{'pass': 'baseline', 'acc': 0.25, 'BitOpsCR': 1.0, 'CR': 1.0},
           {'pass': 'P', 'acc': 0.3125, 'BitOpsCR': 1.42, 'CR': 1.37}]


def _reference_state():
    """A reference chain state that is pruned, factored and has exit heads,
    with one bf16 leaf, its key folded from key(3)."""
    fam = JFamily(JImages())
    p = fam.init(jax.random.key(0), J_RESNET8)
    p, cfg = fam.prune(p, J_RESNET8, 0.3)
    p, cfg, scale = fam.factorize(p, cfg, energy=0.6, min_rank=2)
    p, cfg = fam.add_exits(jax.random.key(1), p, cfg, (0, 1))
    p['stem_norm']['scale'] = p['stem_norm']['scale'].astype(jnp.bfloat16)
    return JState(family=fam, cfg=cfg.replace(w_bits=2, a_bits=8), params=p,
                  key=jax.random.fold_in(jax.random.key(3), 7),
                  base_bitops=1.5e9, base_bits=2_000_000, prune_scale=0.7,
                  lowrank_scale=scale, exit_probs={0: 0.25, 1: 0.5},
                  exit_threshold=0.85, dyn_accuracy=0.5,
                  history=[dict(h) for h in HISTORY])


def _same(got, want):
    """Same leaves in the same order, bit for bit."""
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(b).view(np.uint8))


def _same_state(got, want):
    assert type(got.cfg) is CNNConfig
    assert got.cfg == CNNConfig(**want.cfg.__dict__)
    for k in ('base_bitops', 'base_bits', 'prune_scale', 'lowrank_scale',
              'exit_threshold', 'dyn_accuracy', 'exit_probs', 'history'):
        assert getattr(got, k) == getattr(want, k), k


def test_reference_chain_state_loads_into_the_port(tmp_path):
    want = _reference_state()
    j_save_chain(str(tmp_path), want, step=3)
    fam = CNNFamily(SyntheticImages(), device='cpu')
    got, step = load_chain_state(str(tmp_path), fam)
    assert step == 3 and got.family is fam
    _same_state(got, want)
    assert list(got.exit_probs) == [0, 1]
    _same(got.params, want.params)
    assert got.params['stem_norm']['scale'].dtype == torch.bfloat16
    assert 'u' in got.params['head'] or any(
        'u' in blk['conv1'] for blk in got.params['stages'][2])
    assert got.key == seed_of(jax.random.key_data(want.key))


def test_port_chain_state_loads_into_the_reference(tmp_path):
    ref = _reference_state()
    j_save_chain(str(tmp_path / 'j'), ref, step=0)
    st, _ = load_chain_state(str(tmp_path / 'j'), CPU_FAMILY)
    save_chain_state(str(tmp_path / 't'), st, step=2)
    back, step = j_load_chain(str(tmp_path / 't'), ref.family)
    assert step == 2
    assert dataclasses.asdict(back.cfg) == dataclasses.asdict(ref.cfg)
    _same(st.params, back.params)
    assert np.array_equal(jax.random.key_data(back.key),
                          jax.random.key_data(ref.key))
    assert back.exit_probs == ref.exit_probs and back.history == ref.history


def test_port_round_trip_and_key_map(tmp_path):
    j_save_chain(str(tmp_path / 'j'), _reference_state(), 0)
    st, _ = load_chain_state(str(tmp_path / 'j'), CPU_FAMILY)
    for seed in (0, 5, 2 ** 32 - 1, 2 ** 40 + 3):
        st.key = seed
        save_chain_state(str(tmp_path / 't'), st, step=seed % 7)
        got, step = load_chain_state(str(tmp_path / 't'), CPU_FAMILY,
                                     step=seed % 7)
        assert got.key == seed and step == seed % 7
        _same(got.params, to_numpy(st.params))
        _same_state(got, st)
    # jax.random.key(s) stores (0, s): the port's seed s
    for s in (0, 1, 12345):
        assert seed_of(jax.random.key_data(jax.random.key(s))) == s
        assert np.array_equal(key_data(s),
                              jax.random.key_data(jax.random.key(s)))


def test_checkpoint_leaves_match_the_reference_layout(tmp_path):
    tree = {'b': [torch.arange(6, dtype=torch.int8).reshape(2, 3),
                  {'z': torch.ones(2, dtype=torch.bfloat16),
                   'a': torch.zeros((), dtype=torch.float32)}],
            'a': torch.full((3,), 2.5)}
    d = save_checkpoint(str(tmp_path), 4, tree)
    with open(os.path.join(d, 'manifest.json')) as f:
        leaves = json.load(f)['leaves']
    assert list(leaves) == ['a', 'b/0', 'b/1/a', 'b/1/z']
    assert leaves['b/1/z'] == {'shape': [2], 'dtype': 'bfloat16'}
    got, step = load_checkpoint(str(tmp_path), None, tree)
    assert step == 4
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = jax.tree.map(np.asarray, to_numpy(tree))
    ref, _ = j_load_checkpoint(str(tmp_path), 4, like)
    _same(got, ref)


def test_tmp_step_is_ignored(tmp_path):
    tree = {'w': torch.randn(3, 2)}
    save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / 'step_00000002.tmp')
    assert committed_steps(str(tmp_path)) == [1]
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / 'missing')) is None
    with pytest.raises(FileNotFoundError):
        load_chain_state(str(tmp_path / 'missing'), CPU_FAMILY)


def test_manager_falls_back_past_a_corrupt_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {'w': torch.zeros(4)}
    for step in (1, 2, 3):
        tree['w'] += 1                     # the snapshot is taken at save
        mgr.save(step, tree)
    mgr.wait()
    assert committed_steps(str(tmp_path)) == [2, 3]
    with open(tmp_path / 'step_00000003' / 'proc_0.npz', 'wb') as f:
        f.write(b'not a zip')
    got, step = mgr.restore_latest(tree)
    assert step == 2 and torch.equal(got['w'], torch.full((4,), 2.0))
    with open(tmp_path / 'step_00000002' / 'manifest.json', 'w') as f:
        f.write('{')
    with pytest.raises(FileNotFoundError, match='all corrupt'):
        mgr.restore_latest(tree)
