"""LM architecture registry of the port.

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` the reduced CPU-testable variant (the
reference's ``reduced``).  Only the architectures whose blocks are ported
are registered: ``tinyllama-1.1b`` (GQA attention and SwiGLU).  The CNN
configs live in ``configs/cnn.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

REGISTRY: dict[str, ModelConfig] = {c.name: c for c in [_tinyllama]}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f'unknown arch {name!r}; known: {sorted(REGISTRY)}')
    return REGISTRY[name]


def get_smoke_config(name: str, **kw) -> ModelConfig:
    return reduced(get_config(name), **kw)
