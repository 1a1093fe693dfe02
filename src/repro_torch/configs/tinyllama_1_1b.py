"""tinyllama-1.1b — [arXiv:2401.02385; hf] llama2-arch small, GQA kv=4."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='tinyllama-1.1b', family='dense',
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32_000,
    block_pattern=('global',),
)
