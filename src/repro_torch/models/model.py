"""Unified model API of the LM side: ``build_model(cfg) -> Model``.

The port's counterpart of the reference's ``models/model.py``, for every
block kind of the reference: stacks of attention layers (GQA, 'global'
and 'local', with softcaps and QKV bias; or MLA), RG-LRU ('recurrent')
and Mamba-2 SSD ('ssm') layers, with a dense MLP or an MoE feed-forward
(top-k experts, shared experts, leading dense layers), as a decoder, a
VLM (a batch's ``'patches'`` are a frontend prefix) or an encoder-decoder
(a batch's ``'frames'`` go through :attr:`Model.encode`, and
``decode_step`` takes the encoder output as ``enc``).  ``init`` takes a
``torch.Generator`` and a device where the reference takes a key.
``init`` and ``init_cache`` run on the card unless the caller asks for
``device='cpu'``: without a card they raise (``export.resolve_device``)
instead of falling back to the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (gen, device) -> params
    forward: Callable       # (params, batch, *, remat) -> logits
    prefill: Callable       # (params, batch, *, max_len, ctx) -> ...
    decode_step: Callable   # (params, token, cur, cache, *, enc, ctx) -> ...
    init_cache: Callable    # (batch, max_len, device) -> cache
    encode: Any = None      # encdec only: (params, frames) -> enc


def _batch_parts(cfg, batch):
    """Split a batch dict into (tokens, embeds, frames)."""
    tokens = batch['tokens']
    embeds = batch.get('patches') if cfg.arch_kind == 'vlm' else None
    frames = batch.get('frames') if cfg.arch_kind == 'encdec' else None
    return tokens, embeds, frames


def _positions(x):
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def build_model(cfg: ModelConfig) -> Model:
    from repro_torch.core.export import resolve_device

    def init(gen, device='cuda'):
        return tfm.init_lm(gen, cfg, resolve_device(device))

    def encoded(params, frames, remat=False):
        if frames is None:
            return None, None
        return (tfm.encode(params, cfg, frames, remat=remat),
                _positions(frames))

    def forward(params, batch, *, remat=False, collect_hiddens=False):
        tokens, embeds, frames = _batch_parts(cfg, batch)
        enc, enc_pos = encoded(params, frames, remat)
        return tfm.forward(params, cfg, tokens, embeds=embeds, enc=enc,
                           enc_pos=enc_pos, remat=remat,
                           collect_hiddens=collect_hiddens)

    def prefill(params, batch, *, max_len, ctx=None):
        tokens, embeds, frames = _batch_parts(cfg, batch)
        enc, enc_pos = encoded(params, frames)
        return tfm.prefill(params, cfg, tokens, embeds=embeds, enc=enc,
                           enc_pos=enc_pos, max_len=max_len, ctx=ctx)

    def decode_step(params, token, cur, cache, *, enc=None, ctx=None):
        enc_pos = None if enc is None else _positions(enc)
        return tfm.decode_step(params, cfg, token, cur, cache, ctx=ctx,
                               enc=enc, enc_pos=enc_pos)

    def init_cache(batch, max_len, device='cuda'):
        return tfm.init_cache(cfg, batch, max_len, resolve_device(device))

    encode = (lambda params, frames: tfm.encode(params, cfg, frames)) \
        if cfg.arch_kind == 'encdec' else None

    return Model(cfg=cfg, init=init, forward=forward, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache,
                 encode=encode)


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(p) for p in params)
    return 0
