"""The CNN family adapter (the subset the serving slice needs).

Training, pruning, distillation and factorization come with the
compression chain (ROADMAP, queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models import cnn as cnn_lib


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

    def eval_batches(self, n, batch, seed=10_000):
        """``n`` held-out batches, batch ``i`` drawn from generator seed
        ``seed + i``."""
        return [self.data.batch(torch.Generator().manual_seed(seed + i),
                                batch, device=self.device)
                for i in range(n)]
