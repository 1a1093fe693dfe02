"""Family adapters: the uniform interface the compression passes use, over
CNNs and LMs.

``CNNFamily`` is the subset the serving slices need: init, exit heads,
evaluation batches and the low-rank factorization the L pass applies.
``LMFamily`` is the subset the Q pass needs: init, training and evaluation
batches, the loss, next-token accuracy and the BitOps/storage costs.
Training the CNNs, pruning, distillation, exit heads on the LM side and
the low-rank factorization of LMs come with the rest of the compression
chain (ROADMAP, queue A: the chain and CNN QAT).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import bitops as bo
from repro_torch.models import cnn as cnn_lib
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_map


# ----------------------------------------------------- low-rank SVD helpers


def _svd_split(m, energy, min_rank):
    """Rank-truncated balanced SVD split of a (din, dout) matrix, in numpy
    as the reference does it, so ranks and factors match it exactly.

    Returns (u (din, r), v (r, dout)) as float32 numpy arrays with the
    smallest r keeping ``energy`` of the spectral energy (floored at
    ``min_rank``), or None when no rank saves MACs
    (r * (din + dout) >= din * dout)."""
    m = np.asarray(m, np.float32)
    din, dout = m.shape
    U, S, Vt = np.linalg.svd(m, full_matrices=False)
    tot = float(np.sum(S ** 2))
    if tot <= 0.0:
        return None
    r = int(np.searchsorted(np.cumsum(S ** 2), energy * tot) + 1)
    r = min(max(r, min_rank), len(S))
    if r * (din + dout) >= din * dout:
        return None
    s = np.sqrt(S[:r])
    return U[:, :r] * s, s[:, None] * Vt[:r]


def _linear_cost(tree) -> float:
    """MAC-proportional weight volume: total size of the >=2-D tensors of a
    tree (matmul and conv weights; biases and norm params are free)."""
    if isinstance(tree, torch.Tensor):
        return float(tree.numel()) if tree.dim() >= 2 else 0.0
    if isinstance(tree, dict):
        return sum(_linear_cost(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_linear_cost(v) for v in tree)
    return 0.0


@dataclass
class CNNFamily:
    data: Any                           # SyntheticImages
    image: int = 32
    device: str = 'cpu'

    def init(self, gen: torch.Generator, cfg):
        return cnn_lib.init_cnn(gen, cfg, device=self.device)

    def default_exit_points(self, cfg):
        n = len(cfg.stage_blocks)
        return tuple(range(max(0, n - 3), n - 1))    # last stages before head

    def add_exits(self, gen: torch.Generator, params, cfg, stages):
        """Attach a fresh exit head after each stage in ``stages``, sized off
        the true (possibly pruned/factored) output width of that stage."""
        cfg = cfg.replace(exit_stages=tuple(stages))
        params = dict(params)
        params['exits'] = {}
        for s in stages:
            blk = params['stages'][s][-1]
            if cfg.kind == 'mobilenet':
                dim = cnn_lib.out_channels(blk['project'])
            elif cfg.kind == 'resnet':
                dim = cnn_lib.out_channels(blk['conv2'])
            else:
                dim = cnn_lib.out_channels(blk['conv1'])
            params['exits'][str(s)] = cnn_lib._fc_init(
                gen, dim, cfg.num_classes, self.device)
        return params, cfg

    def factorize(self, params, cfg, *, energy=0.95, min_rank=4):
        """SVD-split stage convs and the head fc (the L pass's family hook);
        returns (params, cfg, mac_scale).

        Each conv w (KH,KW,CIN,COUT) flattens to (KH*KW*CIN, COUT) and, when
        a rank r keeping ``energy`` of the spectral energy saves MACs,
        becomes a spatial conv to r channels ('u', zero bias) chained with a
        1x1 conv back to COUT ('v', the original bias).  Depthwise convs
        and the stem are skipped.  The head becomes ``{'u': {'w'}, 'v':
        {'w', 'b'}}``.  ``mac_scale`` is the stage weight-volume ratio."""
        params = tree_map(lambda t: t, params)     # new dicts and lists
        old_cost = _linear_cost(params['stages'])

        def tensor(a, like):
            return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)

        def factor_conv(p):
            kh, kw, cin, cout = p['w'].shape
            uv = _svd_split(p['w'].detach().cpu().numpy().reshape(
                kh * kw * cin, cout), energy, min_rank)
            if uv is None:
                return p
            u, v = uv
            r = u.shape[-1]
            return {'u': {'w': tensor(u.reshape(kh, kw, cin, r), p['w']),
                          'b': torch.zeros((r,), dtype=p['b'].dtype,
                                           device=p['b'].device)},
                    'v': {'w': tensor(v.reshape(1, 1, r, cout), p['w']),
                          'b': p['b']}}

        for blocks in params['stages']:
            for blk in blocks:
                for k, p in list(blk.items()):
                    if (isinstance(p, dict) and 'w' in p
                            and p['w'].dim() == 4 and k != 'dw'):
                        blk[k] = factor_conv(p)
        head = params['head']
        uv = _svd_split(head['w'].detach().cpu().numpy(), energy, min_rank)
        if uv is not None:
            u, v = uv
            params['head'] = {'u': {'w': tensor(u, head['w'])},
                              'v': {'w': tensor(v, head['w']),
                                    'b': head['b']}}
        scale = _linear_cost(params['stages']) / max(old_cost, 1.0)
        return params, cfg, scale

    def eval_batches(self, n, batch, seed=10_000):
        """``n`` held-out batches, batch ``i`` drawn from generator seed
        ``seed + i``."""
        return [self.data.batch(torch.Generator().manual_seed(seed + i),
                                batch, device=self.device)
                for i in range(n)]


# =============================================================== LM family


_LM_UNPORTED = ('default_exit_points', 'add_exits', 'exit_logits',
                'exit_loss', 'exit_stats', 'shrink', 'prune', 'factorize')


def _unported(what):
    raise NotImplementedError(f'LMFamily.{what} is not ported yet (ROADMAP, '
                              f'queue A: the chain and the other passes)')


@dataclass
class LMFamily:
    """The reference's ``LMFamily`` (``src/repro/core/family.py``) for the
    Q pass.  Batches come from ``torch.Generator``s on the CPU (the
    reference's come from keys) and are placed on ``device``, where
    :meth:`init` also draws the weights."""
    data: Any                           # SyntheticTokens
    seq: int = 128
    device: str = 'cpu'

    def _fwd(self, params, cfg, batch, collect=False):
        if collect:
            _unported('_fwd(collect=True)')
        return tfm.forward(params, cfg, batch['tokens'])

    def init(self, gen: torch.Generator, cfg):
        return tfm.init_lm(gen, cfg, self.device)

    def train_batch(self, gen: torch.Generator, n):
        return self.data.batch(gen, n, self.seq, self.device)

    def logits_of(self, params, cfg, batch):
        return self._fwd(params, cfg, batch)

    def loss(self, params, cfg, batch):
        """(mean next-token cross entropy in fp32, logits)."""
        lg = self._fwd(params, cfg, batch)
        ce = -torch.mean(torch.gather(
            torch.log_softmax(lg.to(torch.float32), dim=-1), -1,
            batch['labels'][..., None]))
        return ce, lg

    def eval_batches(self, n, batch, seed=10_000):
        """``n`` held-out batches, batch ``i`` drawn from generator seed
        ``seed + i``."""
        return [self.data.batch(torch.Generator().manual_seed(seed + i),
                                batch, self.seq, self.device)
                for i in range(n)]

    @torch.no_grad()
    def accuracy(self, params, cfg, batches):
        """Next-token top-1 accuracy (the LM analogue of classification
        acc)."""
        hit = tot = 0
        for b in batches:
            pred = torch.argmax(self._fwd(params, cfg, b), -1)
            hit += int(torch.sum(pred == b['labels']))
            tot += b['labels'].numel()
        return hit / tot

    def bitops(self, cfg, exit_probs=None, mac_scale=1.0):
        # exit indices are scan-group indices -> convert to layer indices
        ep = None
        if exit_probs:
            P = len(cfg.block_pattern)
            ep = {cfg.first_dense_layers + (g + 1) * P - 1: p
                  for g, p in exit_probs.items()}
        return bo.lm_bitops(cfg, self.seq, exit_probs=ep) * mac_scale

    def storage_bits(self, params, cfg):
        return bo.param_storage_bits(params, cfg.w_bits)

    def __getattr__(self, name):
        """The reference's other methods raise until they are ported."""
        if name in _LM_UNPORTED:
            _unported(name)
        raise AttributeError(name)
