"""gemma2-9b — [arXiv:2408.00118; hf] local+global alternating, logit softcap."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='gemma2-9b', family='dense',
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256_000,
    block_pattern=('local', 'global'), window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    tie_embeddings=True, max_seq_len=8192 * 64,
)
