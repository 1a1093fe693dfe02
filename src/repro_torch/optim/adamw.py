"""AdamW and schedules over parameter trees, with the reference's update
formula (``src/repro/optim/adamw.py``), not ``torch.optim.AdamW``'s.

API as the reference's: ``opt = adamw(lr); state = opt.init(params);
updates, state = opt.update(grads, state, params); params =
apply_updates(params, updates)``.  The moments are fp32, the global norm is
summed in fp32 leaf by leaf in the reference's tree order, every division
by a tensor is one IEEE division (a Python scalar is made a tensor first:
torch's ``float / tensor`` multiplies by a reciprocal), and everything
runs under ``torch.no_grad()``.

One departure: ``update`` writes the moments in place and returns a state
holding the same tensors, the single-device form of the reference's
donated optimizer state (at tinyllama-1.1b the moments are 8.8 GB, and a
second copy would be live for the whole update).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    mu: object
    nu: object


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _f32(x, like=None):
    device = like.device if like is not None else 'cpu'
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.1):
    def lr(step):
        step = _f32(step, step if isinstance(step, torch.Tensor) else None)
        warm = torch.clamp(step / _f32(max(warmup, 1), step), max=1.0)
        t = torch.clamp((step - warmup) / _f32(max(total_steps - warmup, 1),
                                               step), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return base_lr * warm * cos
    return lr


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = None
    for g in tree_leaves(grads):
        s = torch.sum(torch.square(g.to(torch.float32)))
        norm = s if norm is None else norm + s
    norm = torch.sqrt(norm)
    scale = torch.clamp(_f32(max_norm, norm) / torch.clamp_min(norm, 1e-9),
                        max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else 'cpu'

        def zeros(p):
            return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                            p)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          mu=zeros(params), nu=zeros(params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        step = state.step + 1
        stepf = step.to(torch.float32)
        lr_t = lr_fn(step)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                u.add_(weight_decay * p.to(torch.float32))
            return (-lr_t * u).to(p.dtype)

        updates = tree_map(upd, grads, state.mu, state.nu, params)
        return updates, AdamWState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
