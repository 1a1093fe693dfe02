"""qwen2-72b — [arXiv:2407.10671; hf] GQA kv=8, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='qwen2-72b', family='dense',
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152_064,
    block_pattern=('global',), qkv_bias=True, rope_theta=1_000_000.0,
)
