#!/usr/bin/env python3
"""How far two devices' Q-pass steps may drift apart, emulated on the CPU.

chip_smoke.py holds one Q-pass step of a 2-layer fp32 tinyllama-1.1b cut on
the card against the same step on the CPU.  The two devices' fp32 matmuls
round their sums differently.  This script puts a number on what that
does, with no card: it runs the step twice on the CPU, once with fp32
products and once with float64 products rounded to fp32 (a second
rounding of the same sums), and once more with the CPU's own weight
fake-quant path (``quantize_weight``) in place of the kernels' plain
version.  For each pair it prints the loss's relative difference, the
largest parameter difference in units of the step's lr, and the share of
parameters more than 1e-2 x lr apart.

    PYTHONPATH=src python scripts/qat_cut_emulation.py --d-model 512
    PYTHONPATH=src python scripts/qat_cut_emulation.py --d-model 2048 --a-bits 0

The 2-layer cut at d_model 2048 holds about 6 GB at once.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import quantization as tq
from repro_torch.core import registry
from repro_torch.core.family import LMFamily
from repro_torch.core.passes import ChainState, Trainer
from repro_torch.data import SyntheticTokens
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves


def step(cfg, params, hp, *, kernel_weights, matmul):
    """One Q-pass step; returns (its loss, the new params)."""
    fq, mm = tq.fake_quant_weight, torch.matmul
    layers.fake_quant_weight = lambda w, bits, axis=-1, use_kernel=None: fq(
        w, bits, axis=axis, use_kernel=kernel_weights and w.dim() == 2
        and bits > 1 and axis in (-1, 1))
    layers.torch.matmul = matmul
    losses = []

    class Family(LMFamily):
        def loss(self, p, c, b):
            ce, lg = super().loss(p, c, b)
            losses.append(float(ce.detach()))
            return ce, lg
    try:
        st = ChainState(family=Family(SyntheticTokens(cfg.vocab_size),
                                      seq=128, device='cpu'), cfg=cfg, params=params, key=0)
        new = registry.get_pass('Q').apply(st, hp, Trainer(batch=2, steps=1,
                                                           lr=1e-3))
    finally:
        layers.fake_quant_weight, layers.torch.matmul = fq, mm
    return losses[0], new.params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--d-model', type=int, default=512)
    ap.add_argument('--a-bits', type=int, default=8)
    args = ap.parse_args()
    d = args.d_model
    cfg = get_config('tinyllama-1.1b').replace(
        num_layers=2, dtype='float32', d_model=d, num_heads=d // 64,
        num_kv_heads=max(1, d // 512))
    params = tfm.init_lm(torch.Generator().manual_seed(0), cfg)
    hp = {'w_bits': 8, 'a_bits': args.a_bits}
    mm = torch.matmul

    def mm64(a, b):
        return mm(a.double(), b.double()).float()

    base = step(cfg, params, hp, kernel_weights=True, matmul=mm)
    lr = 1e-4                                 # the Q pass's: lr / 10
    for name, kw in (('float64-rounded products', dict(kernel_weights=True,
                                                       matmul=mm64)),
                     ("the CPU's weight path", dict(kernel_weights=False,
                                                    matmul=mm))):
        other = step(cfg, params, hp, **kw)
        worst = near = n = 0
        for a, b in zip(tree_leaves(base[1]), tree_leaves(other[1])):
            diff = (a - b).abs()
            worst = max(worst, float(diff.max()))
            near += int((diff > 1e-2 * lr).sum())
            n += diff.numel()
        print(f'd_model {d}, {hp}, {name}: loss |diff| '
              f'{abs(base[0] - other[0]) / base[0]:.3e} x |loss|, params max '
              f'|diff| {worst / lr:.3f} x lr, {near / n:.3e} of them more '
              f'than 1e-2 x lr apart')


if __name__ == '__main__':
    main()
