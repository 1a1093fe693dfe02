"""mixtral-8x7b — [arXiv:2401.04088; hf] 8 experts top-2, sliding-window attn."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='mixtral-8x7b', family='moe',
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32_000,
    block_pattern=('local',), window=4096,
    n_experts=8, top_k=2, moe_d_ff=14336,
)
