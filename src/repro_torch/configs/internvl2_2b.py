"""internvl2-2b — [arXiv:2404.16821; hf] InternViT (stub) + InternLM2-1.8B backbone.

The ViT frontend is a stub: the caller passes precomputed patch
embeddings (batch, patches, d_model) prepended to the text sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='internvl2-2b', family='vlm',
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92_553,
    block_pattern=('global',),
    arch_kind='vlm', frontend_tokens=256,
)
