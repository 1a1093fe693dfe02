"""Synthetic-but-learnable image data (no CIFAR offline).

Class-conditional smooth templates + jitter + noise.  The templates come
from the same numpy generator as the reference's, so they match it
exactly; batches are drawn from a ``torch.Generator`` and so differ from
the reference's ``jax.random`` batches (tests share arrays, not seeds).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SyntheticImages:
    num_classes: int = 10
    size: int = 32
    channels: int = 3
    seed: int = 0
    difficulty: float = 0.8      # noise/signal ratio; higher = harder

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        t = rng.normal(size=(self.num_classes, self.size, self.size,
                             self.channels)).astype(np.float32)
        # smooth the templates so convs with small receptive fields can learn
        for _ in range(2):
            t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)
                 + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5.0
        self.templates = torch.from_numpy(t / t.std())

    def batch(self, gen: torch.Generator, n: int, device='cpu'):
        """(x (n, H, W, C) fp32, y (n,) int64) drawn from the CPU generator
        ``gen``, placed on ``device``."""
        y = torch.randint(0, self.num_classes, (n,), generator=gen)
        shift = torch.randint(-3, 4, (n, 2), generator=gen)
        base = self.templates[y]
        # per-sample roll over (H, W): out[i, j] = img[i - s0, j - s1]
        ar = torch.arange(self.size)
        rows = (ar[None, :] - shift[:, :1]) % self.size
        cols = (ar[None, :] - shift[:, 1:]) % self.size
        base = base[torch.arange(n)[:, None, None], rows[:, :, None],
                    cols[:, None, :]]
        noise = torch.randn(base.shape, generator=gen) * self.difficulty
        scale = 1.0 + 0.1 * torch.randn((n, 1, 1, 1), generator=gen)
        return (base * scale + noise).to(device), y.to(device)
