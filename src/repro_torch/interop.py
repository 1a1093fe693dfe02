"""Parameter trees across the two packages, through numpy.

Both packages keep the same layout (NHWC activations, HWIO conv weights,
(K, N) dense weights, (B, S, K, D) KV caches, scan-stacked ``(G, ...)`` LM
blocks) and the same nested dict/list trees, so a tree crosses with no
transposes: :func:`from_jax_params` turns a tree of arrays (numpy, or
anything ``np.asarray`` reads) into a tree of tensors, and
:func:`to_numpy` goes back.  This module imports no JAX.

bfloat16: JAX hands bf16 arrays to numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses.  Such an array crosses bit for bit as a
uint16 view reinterpreted as ``torch.bfloat16``; the way back views the
bits as ``ml_dtypes.bfloat16`` (imported only then).
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_params(tree, device='cpu'):
    """Tree of arrays -> the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return _tensor(tree).to(device)


def to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays (bf16 tensors as
    ``ml_dtypes.bfloat16`` arrays with the same bits)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree
