"""mamba2-2.7b — [arXiv:2405.21060; unverified] SSD (state-space duality), attn-free.

d_inner = 2*d_model = 5120, headdim 64 → 80 SSD heads, state N=128,
ngroups=1 (B/C shared across heads). Decode carries (B, heads, headdim, N)
recurrent state — O(1) per token, so long_500k runs natively.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='mamba2-2.7b', family='ssm',
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50_280,
    block_pattern=('ssm',),
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    max_seq_len=1_048_576,
)
