"""One-token GQA decode attention: the hand-written CUDA kernels
(``csrc/decode_attention.cu``), their wrappers and their plain versions.

Replaces the reference's Pallas ``decode_attention`` / ``_decode_kernel``
and ``decode_attention_int8`` / ``_decode_kernel_int8``
(src/repro/kernels/decode_attention.py): the g = H / K query heads of each
kv head attend to a (B, S, K, D) cache under a ``valid`` (S,) mask, with
q cast to fp32 and scaled by ``D**-0.5``, fp32 logits, -1e30 for a masked
slot, an fp32 softmax and ``acc / max(l, 1e-30)`` cast to q's dtype.  The
int8 variant reads int8 k/v with an fp32 scale per (token, kv head).
Both take an attention softcap (gemma2), the reference model's
``decode_attn_reference`` (src/repro/models/attention.py), which its TPU
kernels lack: each logit (after ``ks[s] *`` for int8) becomes
``cap * tanh(logit * fp32(1/cap))``, as ``jax.jit`` computes it, before
the mask, so a masked slot keeps -1e30.  ``attn_softcap=0`` is off.
The reference transposes the cache to (B, K, S, D) and fits its S tile to
a divisor of S; the CUDA kernel reads the (B, S, K, D) layout in place and
masks a ragged last tile.  One template serves the three caches: S is
split over a cluster of C blocks (:func:`split_plan`), and an int8 cache
folds its dequantization into one multiply a slot, ``ks[s] * (q . code)``
and ``(p * vs[s]) * code``.  A block takes a kv head's query group padded
to a power of two while that times head_dim is at most ``MAX_GROUP_X_D``;
a larger group runs in chunks of ``MAX_GROUP_X_D // D`` heads, one block
column each, in the same launch (:func:`group_split`: recurrentgemma-9b's
16 query heads over one kv head at head_dim 256 run as two chunks of 8).

:func:`decode_attention` and :func:`decode_attention_int8` launch their
kernel for CUDA tensors and run :func:`decode_attention_plain` /
:func:`decode_attention_int8_plain` for CPU tensors; ``.launches`` on each
wrapper and ``.calls`` on each plain version count which ran.  The plain
versions compute in the kernel's op order with a one-pass softmax (the
kernel's online softmax gives the same function up to fp32 rounding).
A row with no valid slot comes out as the mean of v over all S slots,
as on the TPU; ``models.attention.decode_attn_reference`` gives zeros
there instead.  No decode step makes such a row: the token just written
is always valid.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, recorded
from repro_torch.kernels.tiling import SMEM_BUDGET

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)   # head_dim the kernel is instantiated for
MAX_GROUP = 16                # largest query group H / K it takes
MAX_GROUP_X_D = 2048          # a block's padded group (chunk) x head_dim
# The kernel's split of S over a cluster (csrc/decode_attention.cu): C
# blocks a (kv head, batch row), doubled while the grid has fewer than
# SPLIT_MIN_BLOCKS blocks and each block keeps SPLIT_MIN_SLOTS slots, up
# to the portable cluster size of 8 (so B = 1 runs B * K * 8 blocks: 32 at
# tinyllama's 4 kv heads); a warp for each 16 slots of a block, up to 8 and
# up to what the block's shared memory allows for the cache's element size.
SPLIT_MAX_CLUSTER = 8
SPLIT_MIN_BLOCKS = 132       # one block for each SM of an H100
SPLIT_MIN_SLOTS = 32
SPLIT_MAX_WARPS = 8

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
    [ctypes.c_float] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ARGTYPES_INT8 = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
    [ctypes.c_float] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LAUNCH = {}         # the bound C entry points, set up on first launch


def _launcher(name, argtypes):
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = getattr(_build.load('decode_attention'), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LAUNCH[name] = fn
    return fn


def split_plan(B: int, K: int, S: int, *, elem: int, D: int, G: int,
               chunks: int = 1):
    """The kernel's split of S: ``(C, slots_per_block, warps)`` for a cache
    of ``elem``-byte elements (1 int8, 2 bf16, 4 fp32), head_dim D, a
    block's padded query group G and ``chunks`` blocks for each kv head's
    group (:func:`group_split`): the grid has B * K * chunks * C blocks.
    Block r of the C in a cluster owns slots [r * slots_per_block,
    min((r + 1) * slots_per_block, S))."""
    c = 1
    while c < SPLIT_MAX_CLUSTER and B * K * chunks * c < SPLIT_MIN_BLOCKS and \
            -(-S // (2 * c)) >= SPLIT_MIN_SLOTS:
        c *= 2
    spb = max(1, -(-S // c))
    warps = min(SPLIT_MAX_WARPS, -(-spb // 16))
    while warps > 1 and split_smem_bytes(warps, G, D, elem) > SMEM_BUDGET:
        warps -= 1
    return c, spb, warps


def group_pad(g: int) -> int:
    """The query group rounded up to the power of two the kernels are
    instantiated for."""
    return 1 << (g - 1).bit_length()


def group_split(g: int, D: int):
    """``(G, chunks)``: the padded query group a block takes and the blocks
    a kv head's group of g heads is split into: the whole group padded to a
    power of two where that times D is at most MAX_GROUP_X_D, else chunks
    of MAX_GROUP_X_D // D heads.  A block takes ``min(g, G)`` heads (the
    kernel's ``gc``)."""
    G = group_pad(g)
    if G * D <= MAX_GROUP_X_D:
        return G, 1
    G = MAX_GROUP_X_D // D
    return G, -(-g // G)


def split_smem_bytes(warps: int, G: int, D: int, elem: int) -> int:
    """Shared memory of a block with ``warps`` warps, padded group G,
    head_dim D and ``elem``-byte cache elements (the kernel's
    ``split_smem``): double-buffered k and v tiles of 16 * warps rows of
    D * elem bytes, the query group and the block's acc in fp32, the
    warps' p rows, the k and v scales and the block's (m, l)."""
    return 64 * warps * D * elem + 8 * G * D + 64 * warps * G + \
        256 * warps + 8 * G


def _scale(D: int) -> float:
    """``D**-0.5`` as the fp32 multiplier the kernels apply."""
    return float(np.float32(D ** -0.5))


def _caps(attn_softcap: float):
    """``(cap, fp32(1/cap))`` as the kernels take them; (0, 0) is off."""
    if not attn_softcap:
        return 0.0, 0.0
    return float(attn_softcap), float(np.float32(1.0) /
                                      np.float32(attn_softcap))


def _attend_plain(q, kf, vf, valid, attn_softcap=0.0):
    """The kernels' function on fp32 k/v already dequantized: q (B,H,D),
    kf/vf (B,S,K,D) fp32, valid (S,) bool; returns (B,H,D) in q's dtype."""
    B, H, D = q.shape
    K = kf.shape[2]
    qg = q.to(torch.float32).reshape(B, K, H // K, D) * _scale(D)
    logits = torch.einsum('bkgd,bskd->bkgs', qg, kf)
    if attn_softcap:
        cap, inv = _caps(attn_softcap)
        logits = cap * torch.tanh(logits * inv)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full((), NEG_INF, device=logits.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum('bkgs,bskd->bkgd', p, vf)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_plain(q, k, v, valid, attn_softcap=0.0):
    """The bf16/fp32-cache kernel's function in plain PyTorch."""
    decode_attention_plain.calls += 1
    return _attend_plain(q, k.to(torch.float32), v.to(torch.float32), valid,
                         attn_softcap)


decode_attention_plain.calls = 0


def decode_attention_int8_plain(q, k_q, v_q, k_s, v_s, valid,
                                attn_softcap=0.0):
    """The int8-cache kernel's function in plain PyTorch."""
    decode_attention_int8_plain.calls += 1
    return _attend_plain(q, k_q.to(torch.float32) * k_s[..., None],
                         v_q.to(torch.float32) * v_s[..., None], valid,
                         attn_softcap)


decode_attention_int8_plain.calls = 0


def _check(kernel, q, kv_dtype, caches, scales, valid):
    """Shapes, dtypes, contiguity and alignment the kernels take; raises
    ValueError on anything else (nothing falls back)."""
    if q.dim() != 3 or any(c.dim() != 4 for c in caches):
        raise ValueError(f'{kernel}: q must be (B,H,D) and the cache '
                         f'(B,S,K,D), got {tuple(q.shape)} and '
                         f'{[tuple(c.shape) for c in caches]}')
    B, H, D = q.shape
    S, K = caches[0].shape[1], caches[0].shape[2]
    if caches[0].shape[0] != B or caches[0].shape[3] != D or H % K:
        raise ValueError(f'{kernel}: q {tuple(q.shape)} does not fit the '
                         f'cache {tuple(caches[0].shape)}')
    if D not in HEAD_DIMS or H // K > MAX_GROUP:
        raise ValueError(f'{kernel}: head_dim {D} and group {H // K} are '
                         f'outside the kernel (head_dim in {HEAD_DIMS}, '
                         f'group <= {MAX_GROUP})')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{kernel}: q must be fp32 or bf16, got {q.dtype}')
    want = [(q, q.dtype, None), (valid, torch.bool, (S,))]
    want += [(c, kv_dtype, (B, S, K, D)) for c in caches]
    want += [(s, torch.float32, (B, S, K)) for s in scales]
    _build.check_operands(kernel, q.device, want)
    if any(c.data_ptr() % 16 for c in caches):
        raise ValueError(f'{kernel}: the cache must be 16-byte aligned')
    if B > 65535 or S >= 2 ** 31:
        raise ValueError(f'{kernel}: the cache is too large for the grid')
    return B, S, H, K, D


def da_call_plan(q, **kw):
    """``(route, plan, shared-memory bytes)`` of a call of either wrapper:
    the split kernel on :func:`split_plan` ``(C, slots_per_block,
    warps)``."""
    k = kw['k'] if 'k' in kw else kw['k_q']
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    elem = k.element_size()
    G, chunks = group_split(H // K, D)
    plan = split_plan(B, K, S, elem=elem, D=D, G=G, chunks=chunks)
    return 'split', plan, split_smem_bytes(plan[2], G, D, elem)


@recorded('decode_attention', da_call_plan)
def decode_attention(q, k, v, valid, attn_softcap=0.0):
    """q (B,H,D); k, v (B,S,K,D) in q's dtype (fp32 or bf16); valid (S,)
    bool; ``attn_softcap`` 0 (off) or the cap.  Returns (B,H,D) in q's
    dtype."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, valid, attn_softcap)
    B, S, H, K, D = _check('decode_attention', q, q.dtype, (k, v), (),
                           valid)
    out = torch.empty_like(q)
    elem = k.element_size()
    G, chunks = group_split(H // K, D)
    c, spb, warps = split_plan(B, K, S, elem=elem, D=D, G=G, chunks=chunks)
    rc = _launcher('decode_attention_launch', _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), B, S, H, K, D, _scale(D), *_caps(attn_softcap),
        int(q.dtype == torch.bfloat16), min(H // K, G), c, spb, warps,
        split_smem_bytes(warps, G, D, elem),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        _build.check(_build.load('decode_attention'), rc,
                     'decode_attention launch')
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@recorded('decode_attention_int8', da_call_plan)
def decode_attention_int8(q, k_q, v_q, k_s, v_s, valid, attn_softcap=0.0):
    """q (B,H,D) fp32 or bf16; k_q, v_q int8 (B,S,K,D); k_s, v_s fp32
    (B,S,K); valid (S,) bool; ``attn_softcap`` 0 (off) or the cap.
    Returns (B,H,D) in q's dtype."""
    if not q.is_cuda:
        return decode_attention_int8_plain(q, k_q, v_q, k_s, v_s, valid,
                                           attn_softcap)
    B, S, H, K, D = _check('decode_attention_int8', q, torch.int8,
                           (k_q, v_q), (k_s, v_s), valid)
    out = torch.empty_like(q)
    G, chunks = group_split(H // K, D)
    c, spb, warps = split_plan(B, K, S, elem=1, D=D, G=G, chunks=chunks)
    rc = _launcher('decode_attention_int8_launch', _ARGTYPES_INT8)(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_s.data_ptr(),
        v_s.data_ptr(), valid.data_ptr(), out.data_ptr(), B, S, H, K, D,
        _scale(D), *_caps(attn_softcap), int(q.dtype == torch.bfloat16),
        min(H // K, G), c, spb, warps, split_smem_bytes(warps, G, D, 1),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        _build.check(_build.load('decode_attention'), rc,
                     'decode_attention_int8 launch')
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
