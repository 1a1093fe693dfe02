"""Synthetic-but-learnable datasets (no CIFAR offline).

* Images: class-conditional smooth templates + jitter + noise.
* Tokens: a Zipf-unigram + deterministic-bigram language.

The templates, the unigram and the bigram rules come from the same numpy
generator as the reference's, so they match it exactly; batches are drawn
from a ``torch.Generator`` and so differ from the reference's
``jax.random`` batches (tests share arrays, not seeds).
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


@dataclass
class SyntheticTokens:
    vocab: int
    seed: int = 0
    n_rules: int = 64            # deterministic bigram successor rules

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks
        self.unigram = torch.from_numpy((p / p.sum()).astype(np.float32))
        self.rule_src = torch.from_numpy(
            rng.choice(self.vocab, self.n_rules, replace=False))
        self.rule_dst = torch.from_numpy(rng.choice(self.vocab, self.n_rules))

    def batch(self, gen: torch.Generator, n: int, seq: int, device='cpu'):
        """{'tokens', 'labels'} (n, seq) int64 drawn from the CPU generator
        ``gen``, placed on ``device``: Zipf tokens, then every token that
        follows a rule source becomes that rule's destination."""
        toks = torch.multinomial(self.unigram, n * (seq + 1),
                                 replacement=True, generator=gen)
        toks = toks.reshape(n, seq + 1)
        match = toks[:, :-1, None] == self.rule_src[None, None, :]
        dst = (match.to(torch.int64) * self.rule_dst).sum(-1)
        toks[:, 1:] = torch.where(match.any(-1), dst, toks[:, 1:])
        return {'tokens': toks[:, :-1].to(device),
                'labels': toks[:, 1:].to(device)}


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from ``seed`` and ``data`` (the port's
    ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1)[0])


def image_batches(ds: SyntheticImages, batch, steps, seed=0, device='cpu'):
    """``steps`` batches of ``batch`` images; batch i from a CPU generator
    seeded ``fold_in(seed, i)`` (the reference folds ``i`` into a key)."""
    for i in range(steps):
        yield ds.batch(torch.Generator().manual_seed(fold_in(seed, i)),
                       batch, device)


def lm_batches(ds: SyntheticTokens, batch, seq, steps, seed=0, host_id=0,
               num_hosts=1, device='cpu'):
    """Host-sharded deterministic stream: host h's step i draws
    ``batch // num_hosts`` sequences from a CPU generator seeded
    ``fold_in(fold_in(seed, i), h)``."""
    for i in range(steps):
        gen = torch.Generator().manual_seed(
            fold_in(fold_in(seed, i), host_id))
        yield ds.batch(gen, batch // num_hosts, seq, device)
