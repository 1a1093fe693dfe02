"""Parameter trees across the two packages, through numpy.

Both packages keep the same layout (NHWC activations, HWIO conv weights,
(K, N) dense weights) and the same nested dict/list trees, so a tree
crosses with no transposes: :func:`from_jax_params` turns a tree of
arrays (numpy, or anything ``np.asarray`` reads) into a tree of tensors,
and :func:`to_numpy` goes back.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device='cpu'):
    """Tree of arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return torch.from_numpy(np.array(tree)).to(device)


def to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
