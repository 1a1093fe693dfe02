"""gemma3-12b — [hf:google/gemma-3; unverified] 5:1 local:global, 128k context."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='gemma3-12b', family='dense',
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262_144,
    block_pattern=('local',) * 5 + ('global',), window=1024,
    rope_theta=1_000_000.0, tie_embeddings=True, max_seq_len=131_072,
)
