"""recurrentgemma-9b (Griffin) — [arXiv:2402.19427; unverified] RG-LRU + local attn 1:2.

Pattern is (recurrent, recurrent, local-attention) repeating; 38 layers =
12 full groups + 2 tail recurrent layers. MQA (kv=1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='recurrentgemma-9b', family='hybrid',
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256_000,
    block_pattern=('recurrent', 'recurrent', 'local'), window=2048,
    rglru_width=4096, tie_embeddings=True,
)
