"""deepseek-v3-671b — [arXiv:2412.19437; hf] MLA, 1 shared + 256 routed top-8.

The first 3 layers are dense FFN (d_ff 18432); the remaining layers are MoE
with an expert dim of 2048.  MLA: q_lora 1536, kv_lora 512, rope head dim
64, nope head dim 128, v head 128.  The multi-token-prediction head of the
published model is not part of this config (the reference implements none).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='deepseek-v3-671b', family='moe',
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=192,      # rope(64) + nope(128) per-head q/k dim
    d_ff=18432, vocab_size=129_280,
    block_pattern=('global',),
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
)
