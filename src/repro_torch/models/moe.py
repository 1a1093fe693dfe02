"""Mixture-of-Experts block of the LM side: top-k routing over a softmax,
a fixed capacity per expert and a sort-based dispatch, in PyTorch (the
reference's ``models/moe.py``).

Tokens are argsorted by expert id (a stable sort, as ``jnp.argsort``) and
packed into a dense ``(E, cap, D)`` buffer, where ``cap = int(max(1,
round(T * k / E * capacity_factor)))`` with Python's round-half-even; an
assignment past its expert's ``cap`` goes to an overflow row that is
thrown away (its token gets nothing from that expert).  The experts run
as batched products over the expert axis, and the results come back
weighted by the renormalized gates.

The single-device form of the reference's ``moe_block``: on one device it
always takes ``_moe_block_dense``, and so does the port.  The port
departs from the reference's arithmetic in two places only:

* the counts per expert are an integer ``scatter_add_`` (exact, as
  ``jnp.bincount``; ``torch.bincount`` on a CUDA tensor reads its bounds
  back to the host);
* the combine adds each token's k contributions in ascending expert
  order, one term at a time (the order of the reference's scatter-add
  over the sorted assignments), so the card's sum is deterministic and
  the CPU's equals it; a CUDA ``index_add_`` would add them by atomics.

``REPRO_MOE_MODE`` and the expert-parallel path (``_dispatch_local``,
``_moe_block_ep``: ``shard_map``, ``all_to_all``, ``psum``) are mesh code
and wait with the rest of the distributed code (ROADMAP, queue A item 10).

Expert pruning (the paper's P pass at expert granularity) shrinks the
expert axis of the stacked weights (``core/family.py``).  ``init_moe``
takes a ``stack`` prefix: a scan-stacked layer's leaves are ``(G, E, d,
f)``, the router ``(G, d, E)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import fake_quant_act, fake_quant_weight
from repro_torch.models.layers import dense, he_init, init_dense, init_mlp, mlp


def init_moe(gen, cfg, dtype=torch.float32, device='cpu', stack=()):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(dtype=dtype, device=device)
    p = {'router': init_dense(gen, d, E, stack=stack, **kw),
         'wi': he_init(gen, (*stack, E, d, f), d, **kw),
         'wg': he_init(gen, (*stack, E, d, f), d, **kw),
         'wo': he_init(gen, (*stack, E, f, d), f, **kw)}
    if cfg.n_shared_experts:
        p['shared'] = init_mlp(gen, cfg, cfg.moe_d_ff * cfg.n_shared_experts,
                               stack=stack, **kw)
    return p


def _maybe_quant_w(w, bits):
    """An expert weight as the products take it: the int8 serving form
    dequantized to fp32 (every expert of the layer, as the reference
    does), else fake-quantized at ``bits`` (one scale a column over the
    experts and rows together: ``axis=-1``), else as it is."""
    if isinstance(w, dict):
        return w['w_q'].to(torch.float32) * w['scale']
    return fake_quant_weight(w, bits, axis=-1) if bits else w


def route(p, xf, cfg):
    """Routing of the tokens ``xf`` (T, D): (probs (T, E), gates (T, k),
    eidx (T, k)).  The router runs in fp32 (``dense`` casts its weight to
    x's dtype, as the reference's promotion does); the top-k gates are
    renormalized to sum to one."""
    logits = dense(p['router'], xf.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def capacity(T: int, cfg) -> int:
    """Slots per expert for T tokens (Python's round: half to even)."""
    return int(max(1, round(T * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def dispatch(eidx, n_experts: int, cap: int):
    """Slots of the T * k assignments ``eidx`` (T, k), sorted by expert id
    (stable): (order, keep, dst, src_tok), each (T * k,) in sorted order.
    An assignment is kept while its expert has a free slot; ``dst`` is
    its row of the (E * cap) buffer, the overflow row ``E * cap`` where it
    is dropped; ``src_tok`` its token."""
    T, k = eidx.shape
    eid = eidx.reshape(T * k)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    counts = torch.zeros(n_experts, dtype=eid.dtype,
                         device=eid.device).scatter_add_(
                             0, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=eid.device) - starts[sorted_eid]
    keep = pos_in_e < cap
    dst = torch.where(keep, sorted_eid * cap + pos_in_e,
                      torch.full_like(pos_in_e, n_experts * cap))
    return order, keep, dst, order // k


def moe_block(p, x, cfg, *, quant=(0, 0)):
    """x: (B, S, D) -> (B, S, D): top-k routed experts at a fixed capacity,
    plus the shared expert where the config has one."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)
    _, gates, eidx = route(p, xf, cfg)
    cap = capacity(T, cfg)
    order, keep, dst, src_tok = dispatch(eidx, E, cap)
    buf = x.new_zeros((E * cap + 1, D)).index_copy(0, dst, xf[src_tok])
    buf = buf[:-1].reshape(E, cap, D)

    w_bits, a_bits = quant
    if a_bits:
        buf = fake_quant_act(buf, a_bits)
    wg = _maybe_quant_w(p['wg'], w_bits).to(x.dtype)
    wi = _maybe_quant_w(p['wi'], w_bits).to(x.dtype)
    wo = _maybe_quant_w(p['wo'], w_bits).to(x.dtype)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    if a_bits:
        h = fake_quant_act(h, a_bits)
    out_buf = torch.bmm(h, wo)                                # (E, cap, D)

    flat = torch.cat([out_buf.reshape(E * cap, D), x.new_zeros((1, D))])
    weight = (gates.reshape(T * k)[order] * keep).to(x.dtype)
    gathered = flat[dst] * weight[:, None]
    # each token's assignments in sorted (ascending expert) order
    at = torch.empty_like(order)
    at[order] = torch.arange(T * k, device=x.device)
    terms = gathered[torch.sort(at.reshape(T, k), dim=-1).values]
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]

    if 'shared' in p:
        y = y + mlp(p['shared'], xf, quant=quant)
    return y.reshape(B, S, D)


def moe_aux_loss(p, x, cfg):
    """Load-balancing auxiliary loss (Switch-style f . P)."""
    D = x.shape[-1]
    probs, _, eidx = route(p, x.reshape(-1, D), cfg)
    f = F.one_hot(eidx, cfg.n_experts).sum(1).to(torch.float32).mean(0)
    return cfg.n_experts * torch.sum(f * probs.mean(0))
