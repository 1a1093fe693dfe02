"""BitOps / CR cost model — the paper's compression metrics (a copy of the
reference's ``core/bitops.py``; BitOpsCR and CR are analytic, so the two
packages give the same numbers).

Follows the counting of Li et al. (2019) / Liu et al. (2021) as the paper
does: one MAC at w_bits × a_bits precision costs ``w_bits * a_bits`` BitOps;
a float32 MAC costs 32×32.  BitOpsCR = baseline BitOps / compressed BitOps
(expected over early-exit depth for dynamic models).  CR = storage ratio.

Covers both model families:
  * CNNs (paper-native): per-stage conv/fc MACs from CNNConfig + image size,
  * transformers (assigned archs): per-layer MACs from ModelConfig + seq,
    including GQA/MLA attention, MoE (active experts only), RG-LRU and SSD.
"""
from __future__ import annotations

import numpy as np

from repro_torch.tree import tree_leaves

FP_BITS = 32


# ---------------------------------------------------------------------- CNNs


def cnn_stage_macs(cfg, image=32):
    """Returns (stem, [per-stage], head, {exit: head_macs}) MAC counts."""
    hw = image
    w0 = cfg.stage_widths[0]
    stem = hw * hw * 9 * cfg.in_channels * w0
    cin = w0
    stages = []
    for s, (n, w) in enumerate(zip(cfg.stage_blocks, cfg.stage_widths)):
        macs = 0
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            hw_out = hw // stride
            if cfg.kind == 'resnet':
                macs += hw_out * hw_out * 9 * cin * w
                macs += hw_out * hw_out * 9 * w * w
                if stride != 1 or cin != w:
                    macs += hw_out * hw_out * cin * w
            elif cfg.kind == 'vgg':
                macs += hw_out * hw_out * 9 * cin * w
            else:                                  # mobilenet
                e = cin * cfg.expand_ratio
                macs += hw * hw * cin * e          # expand 1x1
                macs += hw_out * hw_out * 9 * e    # depthwise
                macs += hw_out * hw_out * e * w    # project 1x1
            hw = hw_out
            cin = w
        stages.append(macs)
    head = cin * cfg.num_classes
    exits = {s: cfg.stage_widths[s] * cfg.num_classes
             for s in range(len(cfg.stage_blocks))}
    return stem, stages, head, exits


def cnn_bitops(cfg, image=32, *, exit_probs=None):
    """Total (expected) BitOps for one image.

    ``exit_probs``: {stage: P(exit at stage)} measured on an eval set; the
    remainder runs the full network.  Exit head costs are charged for every
    evaluated exit (the paper's BitOpsCR-with-threshold accounting).
    """
    w_b = cfg.w_bits or FP_BITS
    a_b = cfg.a_bits or FP_BITS
    stem, stages, head, exit_heads = cnn_stage_macs(cfg, image)
    if not exit_probs:
        return (stem + sum(stages) + head) * w_b * a_b
    total = 0.0
    p_remaining = 1.0
    macs_so_far = stem
    for s in range(len(stages)):
        macs_so_far += stages[s]
        if s in exit_probs:
            macs_so_far += exit_heads[s]           # exit head always evaluated
            p_exit = exit_probs[s]
            total += p_remaining * p_exit * macs_so_far
            p_remaining *= (1.0 - p_exit)
    total += p_remaining * (macs_so_far + head)
    return total * w_b * a_b


# --------------------------------------------------------------- transformers


def lm_layer_macs(cfg, seq: int, *, decode: bool = False, ctx_len: int = 0):
    """Per-layer-kind MAC counts for one sequence (or one decode token)."""
    d = cfg.d_model
    S = 1 if decode else seq
    T = ctx_len if decode else seq
    out = {}
    if cfg.num_heads and not cfg.use_mla:
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        proj = S * d * (H + 2 * K) * hd + S * H * hd * d
        for kind, win in (('global', 0), ('local', cfg.window)):
            Teff = min(T, win) if win else T
            attn = S * Teff * H * hd * 2            # qk + pv
            out[kind] = proj + attn
    if cfg.use_mla:
        H = cfg.num_heads
        dr, dn, dv = cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        proj = S * d * r_q + S * r_q * H * (dr + dn) + S * d * (r_kv + dr) \
            + S * r_kv * H * (dn + dv) + S * H * dv * d
        if decode:  # absorbed: latent-space attention
            attn = S * H * (dn * r_kv * 2) + S * T * H * (r_kv + dr) \
                + S * T * H * r_kv
            proj = S * d * r_q + S * r_q * H * (dr + dn) \
                + S * d * (r_kv + dr) + S * H * dv * d
        else:
            attn = S * T * H * (dr + dn + dv)
        out['global'] = proj + attn
    if cfg.d_ff:
        out['mlp'] = S * d * cfg.d_ff * 3           # gated: wi, wg, wo
    if cfg.is_moe:
        active = cfg.top_k + cfg.n_shared_experts
        out['moe'] = S * d * cfg.n_experts \
            + S * d * cfg.moe_d_ff * 3 * active
    if cfg.rglru_width:
        w = cfg.rglru_width
        out['recurrent'] = S * (2 * d * w + 2 * w * w + w * d
                                + cfg.rglru_conv * w)
    if cfg.ssm_state:
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        h = d_in // cfg.ssm_headdim
        io = S * d * (2 * d_in + 2 * n + h) + S * d_in * d
        if decode:
            ssd = h * cfg.ssm_headdim * n * 2
        else:
            L = min(cfg.ssm_chunk, seq)
            ssd = S * L * n + S * L * h * cfg.ssm_headdim \
                + 2 * S * n * h * cfg.ssm_headdim
        out['ssm'] = io + ssd
    return out


def lm_bitops(cfg, seq: int, *, decode=False, ctx_len=0, exit_probs=None):
    """Total (expected) BitOps for one sequence / one decoded token."""
    w_b = cfg.w_bits or FP_BITS
    a_b = cfg.a_bits or FP_BITS
    macs = lm_layer_macs(cfg, seq, decode=decode, ctx_len=ctx_len)
    S = 1 if decode else seq
    kinds = cfg.layer_kinds()
    per_layer = []
    for i, k in enumerate(kinds):
        m = macs.get(k, macs.get('global', 0))
        if k in ('global', 'local'):
            moe_layer = cfg.is_moe and i >= cfg.first_dense_layers
            m += macs['moe'] if moe_layer else macs.get('mlp', 0)
        elif k == 'recurrent':
            m += macs.get('mlp', 0)
        per_layer.append(m)
    unembed = S * cfg.d_model * cfg.vocab_size
    embed = 0                                       # table lookup
    if not exit_probs:
        return (sum(per_layer) + unembed + embed) * w_b * a_b
    total, p_rem, run = 0.0, 1.0, 0.0
    for i, m in enumerate(per_layer):
        run += m
        if i in exit_probs:
            run += unembed                          # exit head = norm+unembed
            total += p_rem * exit_probs[i] * run
            p_rem *= 1.0 - exit_probs[i]
    total += p_rem * (run + unembed)
    return total * w_b * a_b


# ------------------------------------------------------------------- storage


def param_storage_bits(params, w_bits: int = 0) -> int:
    bits = w_bits or FP_BITS
    return sum(int(np.prod(x.shape)) * bits for x in tree_leaves(params))


def compression_summary(base_bitops, base_bits, bitops, bits):
    return {'BitOpsCR': base_bitops / max(bitops, 1),
            'CR': base_bits / max(bits, 1)}
