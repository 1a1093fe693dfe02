"""Unified model API of the LM side: ``build_model(cfg) -> Model``.

The port's counterpart of the reference's ``models/model.py`` for the
blocks it has ported: decoder-only stacks of GQA attention ('global' and
'local') and dense MLPs.  :func:`build_model` raises NotImplementedError
for a config that needs anything else (MoE, MLA, recurrent or SSM blocks,
an encoder or a frontend, softcap).  ``init`` takes a ``torch.Generator``
and a device where the reference takes a key.  ``init`` and ``init_cache``
run on the card unless the caller asks for ``device='cpu'``: without a card
they raise (``export.resolve_device``) instead of falling back to the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (gen, device) -> params
    forward: Callable       # (params, batch) -> logits
    prefill: Callable       # (params, batch, *, max_len) -> (logits, cache)
    decode_step: Callable   # (params, token, cur, cache, *, ctx) -> ...
    init_cache: Callable    # (batch, max_len, device) -> cache


def unported_blocks(cfg: ModelConfig) -> list[str]:
    """What ``cfg`` needs that the port has not ported (empty if none)."""
    why = []
    if cfg.is_moe:
        why.append('MoE experts')
    if cfg.use_mla:
        why.append('MLA attention')
    kinds = sorted(set(cfg.layer_kinds()) - {'global', 'local'})
    if kinds:
        why.append(f'{"/".join(kinds)} blocks')
    if cfg.arch_kind != 'decoder':
        why.append(f'the {cfg.arch_kind} encoder/frontend')
    if cfg.attn_softcap or cfg.logit_softcap:
        why.append('softcap')
    return why


def build_model(cfg: ModelConfig) -> Model:
    from repro_torch.core.export import resolve_device
    why = unported_blocks(cfg)
    if why:
        raise NotImplementedError(
            f'{cfg.name} needs {", ".join(why)}, not ported yet (ROADMAP, '
            f'queue A: the other LM blocks)')

    def init(gen, device='cuda'):
        return tfm.init_lm(gen, cfg, resolve_device(device))

    def forward(params, batch):
        return tfm.forward(params, cfg, batch['tokens'])

    def prefill(params, batch, *, max_len):
        return tfm.prefill(params, cfg, batch['tokens'], max_len=max_len)

    def decode_step(params, token, cur, cache, *, ctx=None):
        return tfm.decode_step(params, cfg, token, cur, cache, ctx=ctx)

    def init_cache(batch, max_len, device='cuda'):
        return tfm.init_cache(cfg, batch, max_len, resolve_device(device))

    return Model(cfg=cfg, init=init, forward=forward, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache)


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(p) for p in params)
    return 0
