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

On one device ``moe_block`` takes ``_moe_block_dense``, as the
reference's does.  The port departs from the reference's arithmetic in
two places only:

* the counts per expert are an integer ``scatter_add_`` (exact, as
  ``jnp.bincount``; ``torch.bincount`` on a CUDA tensor reads its bounds
  back to the host);
* the combine adds each token's k contributions in ascending expert
  order, one term at a time (the order of the reference's scatter-add
  over the sorted assignments), so the card's sum is deterministic and
  the CPU's equals it; a CUDA ``index_add_`` would add them by atomics.

Under a mesh policy (``models/actsharding.py``, installed by the step
builders of ``launch/steps.py``) the block runs expert-parallel
(``_moe_block_ep``, the reference's ``shard_map`` body as one program per
rank on the rank's local tensors), unless ``REPRO_MOE_MODE=dense``.  Two
modes, as the reference's:

* **a2a** (``E % m == 0``, ``S % m == 0``, ``S > 1``; m the 'model'
  size): each 'model' rank takes its ``S/m`` slice of its batch chunk,
  dispatches it locally (``_dispatch_local``), ``all_to_all_single`` on
  the 'model' group turns ``(E, C, D)`` into ``(E/m, C*m, D)`` for the
  rank's own experts, the reverse all-to-all brings the outputs back, the
  local combine runs, and the sequence is all-gathered over 'model';
* **f-TP** (every other case): every expert on every rank, the FFN hidden
  dim cut over 'model', the combined ``(T_local, D)`` output summed over
  'model'.

Each 'model' rank computes the layers downstream replicated, so the
collectives' backward passes are those of a replicated output: the sum's
is the identity, the sequence all-gather's takes the rank's own slice,
the all-to-all's is the reverse exchange, and a replicated input (x, the
router) used by rank-distinct work gets its gradient summed over 'model'
(``_GradSum``; in a2a mode x enters through ``_SeqSlice``, whose backward
all-gathers).  The expert leaves come in as ``LocalShard`` chunks
(``gather_params`` leaves them to this block) and are gathered over the
DP axes only (``actsharding.ep_weight``).  Where 'model' does not divide
the FFN dim (the reference's ``shard_map`` would refuse it) the block
takes the dense path.  Each collective counts itself in the installed
policy's ``counts`` over 'model' (``actsharding.note``), as the
tensor-parallel blocks' do.  In a2a mode GSPMD carries the sequence cut
back into the layer's MLA latent projections
(:func:`splits_sequence`).

Expert pruning (the paper's P pass at expert granularity) shrinks the
expert axis of the stacked weights (``core/family.py``).  ``init_moe``
takes a ``stack`` prefix: a scan-stacked layer's leaves are ``(G, E, d,
f)``, the router ``(G, d, E)``.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import fake_quant_act, fake_quant_weight
from repro_torch.models.actsharding import (LocalShard, current_mesh,
                                            current_policy, ep_weight,
                                            gather_leaf, note, shard_act)
from repro_torch.models.layers import (dense, he_init, init_dense, init_mlp,
                                       mlp, silu)
from repro_torch.tree import tree_map


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
    return _top_k(dense(p['router'], xf.to(torch.float32)), cfg.top_k)


def _top_k(logits, k):
    """(probs, gates, eidx) of router logits: the top-k of the softmax,
    the gates renormalized to sum to one."""
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
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


def _combine(gathered, order, T: int, k: int):
    """(T, D): each token's k weighted expert outputs ``gathered`` (in
    sorted-assignment order) added in ascending expert order, one term at
    a time (deterministic on the card, equal on the CPU)."""
    at = torch.empty_like(order)
    at[order] = torch.arange(T * k, device=order.device)
    terms = gathered[torch.sort(at.reshape(T, k), dim=-1).values]
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y


def moe_block(p, x, cfg, *, quant=(0, 0)):
    """x: (B, S, D) -> (B, S, D): top-k routed experts at a fixed capacity,
    plus the shared expert where the config has one.

    Under an installed mesh policy this dispatches to the expert-parallel
    path (module docstring) when ``REPRO_MOE_MODE`` is not ``dense``, x is
    3-D, the policy's batch was split over the DP axes (the reference's
    ``B % dp == 0`` on the global batch: the port's x is already the
    rank's chunk) and the weights are not the int8 serving form."""
    mesh = current_mesh()
    if mesh is not None:
        if _ep_path(p, x, cfg, _model_size(mesh)):
            return _moe_block_ep(p, x, cfg, mesh, quant=quant)
        p = {n: gather_leaf(v) if isinstance(v, LocalShard) else v
             for n, v in p.items()}
    return _moe_block_dense(p, x, cfg, quant=quant)


def _ep_path(p, x, cfg, m: int) -> bool:
    """Whether :func:`moe_block` takes the expert-parallel path on ``x``
    over a model axis of ``m`` (its docstring)."""
    return os.environ.get('REPRO_MOE_MODE', 'auto') != 'dense' \
        and x.dim() == 3 \
        and getattr(current_policy(), 'batch_split', True) \
        and not isinstance(p['wi'], dict) \
        and (_a2a(cfg, x.shape[1], m) or cfg.moe_d_ff % m == 0)


def splits_sequence(p, x, cfg) -> bool:
    """Whether :func:`moe_block` cuts ``x``'s sequence over 'model' (the
    expert-parallel path in a2a mode, the reference's shard_map in_specs,
    from which GSPMD cuts the layer's attention input projections by
    tokens as well: ``attention.mla_tp_forward``'s ``seq_split``)."""
    mesh = current_mesh()
    if mesh is None:
        return False
    m = _model_size(mesh)
    return m > 1 and _ep_path(p, x, cfg, m) and _a2a(cfg, x.shape[1], m)


def _moe_block_dense(p, x, cfg, *, quant=(0, 0)):
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)
    _, gates, eidx = route(p, xf, cfg)
    cap = capacity(T, cfg)
    order, keep, dst, src_tok = dispatch(eidx, E, cap)
    buf = x.new_zeros((E * cap + 1, D)).index_copy(0, dst, xf[src_tok])
    buf = buf[:-1].reshape(E, cap, D)
    if os.environ.get('REPRO_MOE_MODE', 'auto') != 'dense':
        buf = shard_act(buf, 'moe_buf')

    w_bits, a_bits = quant
    if a_bits:
        buf = fake_quant_act(buf, a_bits)
    wg = _maybe_quant_w(p['wg'], w_bits).to(x.dtype)
    wi = _maybe_quant_w(p['wi'], w_bits).to(x.dtype)
    wo = _maybe_quant_w(p['wo'], w_bits).to(x.dtype)
    h = silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    if a_bits:
        h = fake_quant_act(h, a_bits)
    out_buf = torch.bmm(h, wo)                                # (E, cap, D)

    flat = torch.cat([out_buf.reshape(E * cap, D), x.new_zeros((1, D))])
    weight = (gates.reshape(T * k)[order] * keep).to(x.dtype)
    y = _combine(flat[dst] * weight[:, None], order, T, k)

    if 'shared' in p:
        y = y + mlp(p['shared'], xf, quant=quant)
    return y.reshape(B, S, D)


# ----------------------------------------------------- expert parallelism


def _dispatch_local(xf, logits, E, k, cf):
    """Sort-based dispatch of a rank's LOCAL tokens into an (E, C_l, D)
    buffer.  Returns (buf, dst, src_tok, gate_keep, order) for the combine.
    A masked scatter-add (no overflow row: a dropped assignment adds
    zeros to row 0), so the buffer is exactly (E * C_l, D)."""
    T, D = xf.shape
    _, gates, eidx = _top_k(logits, k)
    cap = int(max(1, round(T * k / E * cf)))
    order, keep, dst, src_tok = dispatch(eidx, E, cap)
    dst = torch.where(keep, dst, torch.zeros_like(dst))
    src = xf[src_tok] * keep[:, None].to(xf.dtype)
    buf = xf.new_zeros((E * cap, D)).index_add(0, dst, src)
    gate_keep = (gates.reshape(T * k)[order] * keep).to(xf.dtype)
    return buf.reshape(E, cap, D), dst, src_tok, gate_keep, order


class _GradSum(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over the
    'model' group (a replicated input used by rank-distinct work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        note('all_reduce', g, 'model')
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Sum(torch.autograd.Function):
    """Forward: the sum over the 'model' group (f-TP's partial outputs).
    Backward: the identity (the sum is replicated and consumed once a
    rank)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        note('all_reduce', y, 'model')
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks of dim 0 over the group; its
    own adjoint, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        note('all_to_all', x, 'model')
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous()
        out = torch.empty_like(g)
        note('all_to_all', g, 'model')
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def _gather_seq(x, group, m):
    import torch.distributed as dist
    x = x.contiguous()
    note('all_gather', x, 'model')
    parts = [torch.empty_like(x) for _ in range(m)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


class _SeqGather(torch.autograd.Function):
    """Forward: (Bl, S/m, D) -> (Bl, S, D), the sequence all-gathered over
    'model' in rank order.  Backward: the rank's own slice (the output is
    replicated, each rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, m, j):
        ctx.j, ctx.n = j, x.shape[1]
        return _gather_seq(x, group, m)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.j * ctx.n
        return g[:, lo:lo + ctx.n].contiguous(), None, None, None


class _SeqSlice(torch.autograd.Function):
    """Forward: (Bl, S, D) -> the rank's (Bl, S/m, D) slice.  Backward:
    the slices' gradients all-gathered (each rank's slice was used only
    there)."""

    @staticmethod
    def forward(ctx, x, group, m, j):
        ctx.group, ctx.m = group, m
        n = x.shape[1] // m
        return x[:, j * n:(j + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.group, ctx.m), None, None, None


def _model_size(mesh) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index('model'))


def _a2a(cfg, S: int, m: int) -> bool:
    """The a2a mode: 'model' divides the experts and the sequence (token
    parallelism on 'model'; else every column would dispatch the same
    tokens)."""
    return cfg.n_experts % m == 0 and S % m == 0 and S > 1


def _moe_block_ep(p, x, cfg, mesh, *, quant=(0, 0)):
    """Expert-parallel MoE on a rank's local x (Bl, S, D): a2a or f-TP
    mode (module docstring).  Returns the rank's (Bl, S, D), replicated
    over 'model'."""
    Bl, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    m = _model_size(mesh)
    j = mesh.get_local_rank('model')
    group = mesh.get_group('model')
    w_bits, a_bits = quant
    a2a = _a2a(cfg, S, m)
    router = tree_map(lambda t: _GradSum.apply(t, group), p['router'])
    if a2a:
        xs = _SeqSlice.apply(x, group, m, j)
    else:
        xs = _GradSum.apply(x, group)
    wi, wg, wo = (ep_weight(p[n], mesh, 0 if a2a else dim)
                  for n, dim in (('wi', 2), ('wg', 2), ('wo', 1)))
    Sl = xs.shape[1]
    T = Bl * Sl
    xf = xs.reshape(T, D)
    logits = dense(router, xf.to(torch.float32))
    buf, dst, src_tok, gk, order = _dispatch_local(xf, logits, E, k,
                                                   cfg.capacity_factor)
    cap = buf.shape[1]
    if a2a:                                  # (E, C, D) -> (E/m, C*m, D)
        recv = _AllToAll.apply(buf, group)   # (m, E/m, C, D) by source
        buf = recv.reshape(m, E // m, cap, D).transpose(0, 1) \
            .reshape(E // m, m * cap, D)
    if a_bits:
        buf = fake_quant_act(buf, a_bits)
    wi_, wg_, wo_ = (_maybe_quant_w(w, w_bits).to(x.dtype)
                     for w in (wi, wg, wo))
    h = silu(torch.bmm(buf, wg_)) * torch.bmm(buf, wi_)
    if a_bits:
        h = fake_quant_act(h, a_bits)
    out_buf = torch.bmm(h, wo_)
    if a2a:                                  # back to (E, C, D)
        send = out_buf.reshape(E // m, m, cap, D).transpose(0, 1)
        out_buf = _AllToAll.apply(send, group).reshape(E, cap, D)
    flat = out_buf.reshape(E * cap, D)
    y = _combine(flat[dst] * gk[:, None], order, T, k)
    if not a2a:
        y = _Sum.apply(y, group)             # f-TP partial sums
    y = y.reshape(Bl, Sl, D)
    if a2a:
        y = _SeqGather.apply(y, group, m, j)
    if 'shared' in p:                        # shared expert: the plain MLP
        y = y + mlp(p['shared'], x, quant=quant)
    return y


def moe_aux_loss(p, x, cfg):
    """Load-balancing auxiliary loss (Switch-style f . P)."""
    D = x.shape[-1]
    probs, _, eidx = route(p, x.reshape(-1, D), cfg)
    f = F.one_hot(eidx, cfg.n_experts).sum(1).to(torch.float32).mean(0)
    return cfg.n_experts * torch.sum(f * probs.mean(0))
