"""Model configuration dataclass of the LM side.

A copy of the reference's ``configs/base.py`` (field for field, so a
config means the same model in both packages).  ``configs/__init__.py``
registers every architecture of the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention structure ----------------------------------------------
    # Repeating unit of block kinds, cycled over layers.
    # kinds: 'global' | 'local' | 'recurrent' | 'ssm'
    block_pattern: tuple = ('global',)
    window: int = 4096               # sliding-window size for 'local' blocks
    logit_softcap: float = 0.0       # final-logit soft capping (gemma2)
    attn_softcap: float = 0.0        # attention-logit soft capping (gemma2)
    qkv_bias: bool = False           # qwen2-style bias on QKV projections
    rope_theta: float = 10_000.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek-v3: leading dense layers
    capacity_factor: float = 1.25

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- RG-LRU (recurrentgemma) ----------------------------------------------
    rglru_width: int = 0
    rglru_conv: int = 4

    # --- structural kind --------------------------------------------------------
    arch_kind: str = 'decoder'       # decoder | encdec | vlm
    num_encoder_layers: int = 0      # encdec only
    frontend_tokens: int = 0         # vlm patches / audio frames (stubbed input)
    max_seq_len: int = 131_072

    # --- numerics / sharding profile ---------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = 'bfloat16'
    shard_heads: bool = True         # False when num_heads % model-axis != 0

    # --- compression hooks (paper technique) ---------------------------------------
    w_bits: int = 0                  # 0 = full precision (no fake-quant)
    a_bits: int = 0
    kv_cache_bits: int = 0           # 8 -> int8 KV cache (serving)
    exit_layers: tuple = ()          # indices of layers with early-exit heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> tuple:
        """Expanded per-layer kind list (length == num_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def replace(self, **kw) -> 'ModelConfig':
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, *, layers: int | None = None) -> ModelConfig:
    """Shrink a full config to a CPU-smoke-testable size, same family/pattern.

    Keeps the block pattern (at least one full repeat), divisibility of heads,
    and all structural flags, so the smoke test exercises the same code paths
    as the full config.
    """
    pat = len(cfg.block_pattern)
    n_layers = layers if layers is not None else max(pat, 2)
    kw = dict(
        name=cfg.name + '-smoke',
        num_layers=n_layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        window=min(cfg.window, 64),
        max_seq_len=256,
        dtype='float32',
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=64,
                  n_shared_experts=cfg.n_shared_experts,
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.use_mla:
        kw.update(q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32, head_dim=48)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32,
                  num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0)
    if cfg.rglru_width:
        kw.update(rglru_width=128)
    if cfg.arch_kind == 'encdec':
        kw.update(num_encoder_layers=2)
    if cfg.frontend_tokens:
        kw.update(frontend_tokens=8)
    return cfg.replace(**kw)
