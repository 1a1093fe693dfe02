"""whisper-small — [arXiv:2212.04356; unverified] enc-dec; conv frontend stubbed.

The audio frontend (log-mel + conv) is a stub: the caller passes
precomputed frame embeddings (batch, frames, d_model) for the encoder.
12 heads are not divisible by the 16-way model axis → shard_heads=False
(attention replicated, FFN tensor-parallel; whisper-small is tiny so TP on
attention is not load-bearing).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='whisper-small', family='audio',
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51_865,
    block_pattern=('global',),
    arch_kind='encdec', num_encoder_layers=12, frontend_tokens=1500,
    shard_heads=False,
)
