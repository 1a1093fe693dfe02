"""LM architecture registry of the port.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` the reduced CPU-testable variant (the
reference's ``reduced``).  Every architecture of the reference, in its
registry order: the dense-attention members (GQA attention, global and
sliding-window, softcap, QKV bias, a frontend prefix and an encoder with
cross-attention), recurrentgemma-9b (RG-LRU and MQA local layers),
mixtral-8x7b (MoE), deepseek-v3-671b (MLA, shared experts, leading dense
layers) and mamba2-2.7b (SSD).  The CNN configs live in
``configs/cnn.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.gemma2_9b import CONFIG as _gemma2_9b
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3_12b
from repro_torch.configs.internvl2_2b import CONFIG as _internvl
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.whisper_small import CONFIG as _whisper

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [_gemma2_9b, _gemma3_12b, _tinyllama, _qwen2, _rgemma,
                        _mixtral, _dsv3, _whisper, _internvl, _mamba2]}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f'unknown arch {name!r}; known: {sorted(REGISTRY)}')
    return REGISTRY[name]


def get_smoke_config(name: str, **kw) -> ModelConfig:
    return reduced(get_config(name), **kw)
