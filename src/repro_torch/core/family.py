"""Family adapters: the uniform interface the compression passes use, over
CNNs and LMs (the reference's ``core/family.py``).

The passes are family-agnostic; everything model-specific lives here.
``CNNFamily`` is whole: the forward and the losses, distillation's student
(``shrink``), physical channel pruning (``prune``), the low-rank
factorization the L pass applies, exit heads and their dynamic statistics
(``exit_stats``), and the BitOps/storage costs.  ``LMFamily`` has the same
hooks over the LM decoder: a shallower student, d_ff channel pruning (of
an MoE config, expert pruning), the stacked ``(G, d, f)`` SVD with one
shared rank, exit heads after scan groups and their per-token
statistics.

Where the port departs from the reference:

* Each family has a ``device``, ``'cuda'`` unless the caller asks for
  ``'cpu'``; a family asked for the card on a host without one raises when
  it is made (the chain's entry points run where the family says).
* Random draws come from ``torch.Generator``s, which each family makes with
  :meth:`generator`: a CNN draws on the CPU and moves its weights to the
  device, so the card and the CPU start from the same weights; an LM draws
  on its device.
* The reference jits the forwards of ``accuracy`` and ``exit_stats``; the
  port computes their QAT scales with the jitted arithmetic
  (``quantization.jitted_scales``) and, on the card, without TF32
  (``quantization.full_fp32``).
* ``prune``'s channel importance (and an MoE config's expert importance)
  is summed in float64 (the reference's in the weights' dtype), so the
  card and the CPU keep the same channels; numpy's argsort picks them, as
  in the reference, which keeps the same channels except at a tie within
  fp32 rounding.
* ``LMFamily.factorize`` takes the stacked weights' SVDs from an fp64
  Gram eigendecomposition on the card (``_gram_svd``) and numpy's SVD on
  the CPU (the reference's); the rank rule reads the singular values in
  numpy on the host either way.  The sign of a singular pair is free, so
  the card's factors equal the CPU's up to sign per pair and fp32
  rounding; their product ``u @ v`` is what the two share.
* ``LMFamily.exit_stats`` applies the reference's per-token exit rule on
  the device (the reference's runs in numpy on the host) under
  ``jitted_scales`` and ``full_fp32``, as ``CNNFamily.exit_stats``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import bitops as bo
from repro_torch.core.quantization import full_fp32, jitted_scales
from repro_torch.models import cnn as cnn_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (dense, init_dense, init_norm,
                                       rms_norm, softcap, unembed)
from repro_torch.tree import tree_map


# ----------------------------------------------------- low-rank SVD helpers


def _svd_split(m, energy, min_rank):
    """Rank-truncated balanced SVD split of a (din, dout) matrix, in numpy
    as the reference does it, so ranks and factors match it exactly.

    Returns (u (din, r), v (r, dout)) as float32 numpy arrays with the
    smallest r keeping ``energy`` of the spectral energy (floored at
    ``min_rank``), or None when no rank saves MACs
    (r * (din + dout) >= din * dout)."""
    m = np.asarray(m, np.float32)
    din, dout = m.shape
    U, S, Vt = np.linalg.svd(m, full_matrices=False)
    tot = float(np.sum(S ** 2))
    if tot <= 0.0:
        return None
    r = int(np.searchsorted(np.cumsum(S ** 2), energy * tot) + 1)
    r = min(max(r, min_rank), len(S))
    if r * (din + dout) >= din * dout:
        return None
    s = np.sqrt(S[:r])
    return U[:, :r] * s, s[:, None] * Vt[:r]


def _linear_cost(tree) -> float:
    """MAC-proportional weight volume: total size of the >=2-D tensors of a
    tree (matmul and conv weights; biases and norm params are free)."""
    if isinstance(tree, torch.Tensor):
        return float(tree.numel()) if tree.dim() >= 2 else 0.0
    if isinstance(tree, dict):
        return sum(_linear_cost(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_linear_cost(v) for v in tree)
    return 0.0


def _any_factored(tree) -> bool:
    """True if any weight in the tree is a low-rank {'u','v'} pair.

    Factorization is per-weight (only where a rank saves MACs), so a model
    can be *partially* factored: the prune guards walk the whole tree."""
    if isinstance(tree, dict):
        if 'u' in tree and 'v' in tree:
            return True
        return any(_any_factored(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_factored(v) for v in tree)
    return False


def _cross_entropy(logits, y):
    """Mean cross entropy of ``logits`` (B, classes) against labels y."""
    return -torch.mean(torch.gather(torch.log_softmax(logits, dim=-1), 1,
                                    y[:, None]))


def _check_device(device):
    """Raise unless ``device`` is usable here: a family runs on the card
    unless the caller asks for the CPU, and never falls back to it."""
    from repro_torch.core.export import resolve_device
    resolve_device(device)


@dataclass
class CNNFamily:
    data: Any                           # SyntheticImages
    image: int = 32
    device: str = 'cuda'

    def __post_init__(self):
        _check_device(self.device)

    # ----- basics
    def generator(self, seed: int) -> torch.Generator:
        """The generator :meth:`init` and :meth:`add_exits` draw from: on
        the CPU whatever ``device`` is (the weights are drawn there and
        moved), so every device starts from the same weights."""
        return torch.Generator().manual_seed(seed)

    def init(self, gen: torch.Generator, cfg):
        return cnn_lib.init_cnn(gen, cfg, device=self.device)

    def train_batch(self, gen: torch.Generator, n):
        return self.data.batch(gen, n, device=self.device)

    def logits(self, params, cfg, x, collect_exits=False):
        return cnn_lib.cnn_forward(params, cfg, x,
                                   collect_exits=collect_exits)

    def logits_of(self, params, cfg, batch):
        return self.logits(params, cfg, batch[0])

    def default_exit_points(self, cfg):
        n = len(cfg.stage_blocks)
        return tuple(range(max(0, n - 3), n - 1))    # last stages before head

    def exit_loss(self, params, cfg, batch):
        """(mean over the exit heads of their cross entropy, exit logits)."""
        x, y = batch
        _, exits = self.logits(params, cfg, x, collect_exits=True)
        ce = 0.0
        for lg in exits.values():
            ce = ce + _cross_entropy(lg, y)
        return ce / max(len(exits), 1), exits

    def loss(self, params, cfg, batch):
        x, y = batch
        lg = self.logits(params, cfg, x)
        return _cross_entropy(lg, y), lg

    def eval_batches(self, n, batch, seed=10_000):
        """``n`` held-out batches, batch ``i`` drawn from generator seed
        ``seed + i``."""
        return [self.data.batch(torch.Generator().manual_seed(seed + i),
                                batch, device=self.device)
                for i in range(n)]

    @torch.no_grad()
    def accuracy(self, params, cfg, batches):
        hit = tot = 0
        with jitted_scales(), full_fp32():
            for x, y in batches:
                pred = torch.argmax(self.logits(params, cfg, x), -1)
                hit += int(torch.sum(pred == y))
                tot += y.numel()
        return hit / tot

    # ----- distillation
    def shrink(self, cfg, factor):
        """Student config: depth-shrink resnet/vgg, width-shrink mobilenet."""
        if cfg.kind == 'mobilenet':
            widths = tuple(max(8, int(w * factor) // 8 * 8)
                           for w in cfg.stage_widths)
            return cfg.replace(name=cfg.name + '-student',
                               stage_widths=widths)
        blocks = tuple(max(1, round(b * factor)) for b in cfg.stage_blocks)
        if blocks == cfg.stage_blocks:               # depth already minimal
            widths = tuple(max(8, int(w * factor) // 4 * 4)
                           for w in cfg.stage_widths)
            return cfg.replace(name=cfg.name + '-student',
                               stage_widths=widths)
        return cfg.replace(name=cfg.name + '-student', stage_blocks=blocks)

    # ----- pruning (physical channel shrink)
    def prune(self, params, cfg, ratio):
        """Prune inner conv channels by L2 importance; returns (params,
        cfg).  resnet prunes each block's conv1 outputs (and conv2's
        inputs), mobilenet each expansion, vgg every conv in a chain (and
        the head's rows), keeping ``max(4, int(C * (1 - ratio)))``."""
        if _any_factored(params):
            raise ValueError(
                'cannot channel-prune a low-rank-factored CNN: apply P '
                'before L (the sequence law orders neuron-granularity '
                'before sub-neuron)')
        params = tree_map(lambda t: t, params)       # new dicts and lists

        def topk_idx(w, keep):                        # w: (..., C)
            imp = torch.sqrt(torch.sum(torch.square(w.to(torch.float64)),
                                       dim=tuple(range(w.dim() - 1))))
            idx = np.sort(np.argsort(imp.cpu().numpy())[::-1][:keep])
            return torch.from_numpy(idx).to(w.device)

        def norm(p, idx):
            return {'scale': p['scale'][idx], 'bias': p['bias'][idx]}

        for blocks in params['stages']:
            for blk in blocks:
                if cfg.kind == 'resnet':
                    C = blk['conv1']['w'].shape[-1]
                    idx = topk_idx(blk['conv1']['w'],
                                   max(4, int(C * (1 - ratio))))
                    blk['conv1'] = {'w': blk['conv1']['w'][..., idx],
                                    'b': blk['conv1']['b'][idx]}
                    blk['n1'] = norm(blk['n1'], idx)
                    blk['conv2'] = {'w': blk['conv2']['w'][:, :, idx, :],
                                    'b': blk['conv2']['b']}
                elif cfg.kind == 'mobilenet':
                    E = blk['expand']['w'].shape[-1]
                    idx = topk_idx(blk['expand']['w'],
                                   max(4, int(E * (1 - ratio))))
                    blk['expand'] = {'w': blk['expand']['w'][..., idx],
                                     'b': blk['expand']['b'][idx]}
                    blk['n1'] = norm(blk['n1'], idx)
                    blk['dw'] = {'w': blk['dw']['w'][..., idx],
                                 'b': blk['dw']['b'][idx]}
                    blk['n2'] = norm(blk['n2'], idx)
                    blk['project'] = {'w': blk['project']['w'][:, :, idx, :],
                                      'b': blk['project']['b']}
        if cfg.kind == 'vgg':                         # chained
            prev_idx = None
            for blocks in params['stages']:
                for blk in blocks:
                    w = blk['conv1']['w']
                    if prev_idx is not None:
                        w = w[:, :, prev_idx, :]
                    C = w.shape[-1]
                    idx = topk_idx(w, max(4, int(C * (1 - ratio))))
                    blk['conv1'] = {'w': w[..., idx],
                                    'b': blk['conv1']['b'][idx]}
                    blk['n1'] = norm(blk['n1'], idx)
                    prev_idx = idx
            params['head'] = {'w': params['head']['w'][prev_idx, :],
                              'b': params['head']['b']}
            cfg = cfg.replace(stage_widths=tuple(
                max(4, int(w * (1 - ratio))) for w in cfg.stage_widths))
        return params, cfg

    def pruned_bitops_scale(self, ratio, cfg):
        """Fraction of stage MACs remaining after inner-channel pruning."""
        if cfg.kind == 'vgg':
            return 1.0                                # already in cfg widths
        return 1.0 - ratio                            # inner convs dominate

    def add_exits(self, gen: torch.Generator, params, cfg, stages):
        """Attach a fresh exit head after each stage in ``stages``, sized off
        the true (possibly pruned/factored) output width of that stage."""
        cfg = cfg.replace(exit_stages=tuple(stages))
        params = dict(params)
        params['exits'] = {}
        for s in stages:
            blk = params['stages'][s][-1]
            if cfg.kind == 'mobilenet':
                dim = cnn_lib.out_channels(blk['project'])
            elif cfg.kind == 'resnet':
                dim = cnn_lib.out_channels(blk['conv2'])
            else:
                dim = cnn_lib.out_channels(blk['conv1'])
            params['exits'][str(s)] = cnn_lib._fc_init(
                gen, dim, cfg.num_classes, self.device)
        return params, cfg

    def factorize(self, params, cfg, *, energy=0.95, min_rank=4):
        """SVD-split stage convs and the head fc (the L pass's family hook);
        returns (params, cfg, mac_scale).

        Each conv w (KH,KW,CIN,COUT) flattens to (KH*KW*CIN, COUT) and, when
        a rank r keeping ``energy`` of the spectral energy saves MACs,
        becomes a spatial conv to r channels ('u', zero bias) chained with a
        1x1 conv back to COUT ('v', the original bias).  Depthwise convs
        and the stem are skipped.  The head becomes ``{'u': {'w'}, 'v':
        {'w', 'b'}}``.  ``mac_scale`` is the stage weight-volume ratio."""
        params = tree_map(lambda t: t, params)     # new dicts and lists
        old_cost = _linear_cost(params['stages'])

        def tensor(a, like):
            return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)

        def factor_conv(p):
            kh, kw, cin, cout = p['w'].shape
            uv = _svd_split(p['w'].detach().cpu().numpy().reshape(
                kh * kw * cin, cout), energy, min_rank)
            if uv is None:
                return p
            u, v = uv
            r = u.shape[-1]
            return {'u': {'w': tensor(u.reshape(kh, kw, cin, r), p['w']),
                          'b': torch.zeros((r,), dtype=p['b'].dtype,
                                           device=p['b'].device)},
                    'v': {'w': tensor(v.reshape(1, 1, r, cout), p['w']),
                          'b': p['b']}}

        for blocks in params['stages']:
            for blk in blocks:
                for k, p in list(blk.items()):
                    if (isinstance(p, dict) and 'w' in p
                            and p['w'].dim() == 4 and k != 'dw'):
                        blk[k] = factor_conv(p)
        head = params['head']
        uv = _svd_split(head['w'].detach().cpu().numpy(), energy, min_rank)
        if uv is not None:
            u, v = uv
            params['head'] = {'u': {'w': tensor(u, head['w'])},
                              'v': {'w': tensor(v, head['w']),
                                    'b': head['b']}}
        scale = _linear_cost(params['stages']) / max(old_cost, 1.0)
        return params, cfg, scale

    # ----- early exit
    @torch.no_grad()
    def exit_stats(self, params, cfg, batches, threshold):
        """(accuracy, exit_probs) of the dynamic early-exit model: a sample
        leaves at the first exit whose softmax confidence exceeds
        ``threshold``; ``exit_probs[s]`` is the share of the samples that
        reach stage ``s`` and leave there."""
        probs = {s: [0, 0] for s in cfg.exit_stages}
        hit = tot = 0
        with jitted_scales(), full_fp32():
            for x, y in batches:
                final, exits = self.logits(params, cfg, x,
                                           collect_exits=True)
                alive = np.ones(y.shape[0], bool)
                pred = torch.argmax(final, -1).cpu().numpy()
                for s in cfg.exit_stages:
                    p = torch.softmax(exits[s], dim=-1).cpu().numpy()
                    conf = p.max(-1) > threshold
                    take = alive & conf
                    probs[s][0] += int(take.sum())
                    probs[s][1] += int(alive.sum())
                    pred[take] = p.argmax(-1)[take]
                    alive &= ~conf
                hit += int((pred == y.cpu().numpy()).sum())
                tot += y.numel()
        exit_probs = {s: (c / max(n, 1)) for s, (c, n) in probs.items()}
        return hit / tot, exit_probs

    # ----- costs
    def bitops(self, cfg, exit_probs=None, mac_scale=1.0):
        """Expected BitOps; ``mac_scale`` multiplies stage MACs (pruning x
        low-rank: ChainState.mac_scale combines them)."""
        stem, stages, head, exits = bo.cnn_stage_macs(cfg, self.image)
        w_b = cfg.w_bits or bo.FP_BITS
        a_b = cfg.a_bits or bo.FP_BITS
        if not exit_probs:
            return (stem + sum(stages) * mac_scale + head) * w_b * a_b
        total, p_rem, run = 0.0, 1.0, float(stem)
        for s in range(len(stages)):
            run += stages[s] * mac_scale
            if s in exit_probs:
                run += exits[s]
                total += p_rem * exit_probs[s] * run
                p_rem *= 1 - exit_probs[s]
        total += p_rem * (run + head)
        return total * w_b * a_b

    def storage_bits(self, params, cfg):
        return bo.param_storage_bits(params, cfg.w_bits)


# =============================================================== LM family


def _lm_svd(w):
    """(U, S, Vt) of a stacked (G, d, f) weight, S as a float32 numpy array
    for the rank rule: numpy's LAPACK SVD in fp32 on the CPU (the
    reference's, so ranks and factors match it exactly, U and Vt numpy
    too), :func:`_gram_svd` on the card."""
    if w.is_cuda:
        return _gram_svd(w)
    return np.linalg.svd(w.detach().to(torch.float32).numpy(),
                         full_matrices=False)


def _gram_svd(w):
    """The SVD of a stacked (G, d, f) weight from the fp64 eigendecomposition
    of its smaller Gram matrix (``torch.linalg.eigh``), singular values in
    descending order: exact to fp64 for the singular pairs a rank keeps,
    so the card's factors are the CPU's up to the sign of each pair and
    the CPU's own fp32 rounding.  cuSOLVER's fp32 ``torch.linalg.svd``
    (Jacobi) moved ``u @ v`` by 5.8e-3 x max at tinyllama's (2048, 3942)
    on an H100, and a host SVD of that shape takes seconds."""
    a = w.detach().to(torch.float64)
    transpose = a.shape[-2] > a.shape[-1]
    if transpose:
        a = a.transpose(-1, -2)
    lam, U = torch.linalg.eigh(a @ a.transpose(-1, -2))
    lam, U = lam.flip(-1), U.flip(-1)
    S = torch.sqrt(torch.clamp_min(lam, 0.0))
    Vt = (U.transpose(-1, -2) @ a) / torch.clamp_min(S, 1e-300)[..., None]
    if transpose:
        U, Vt = Vt.transpose(-1, -2), U.transpose(-1, -2)
    return U, S.to(torch.float32).cpu().numpy(), Vt


def _balanced(U, S, Vt, r, like):
    """The rank-r balanced split ``(U_r sqrt(S_r), sqrt(S_r) Vt_r)`` of a
    stacked SVD, as fp32 tensors on ``like``'s device (the reference's
    factors are float32 whatever the weight's dtype)."""
    if isinstance(U, np.ndarray):
        s = np.sqrt(S[..., :r])
        u, v = U[..., :r] * s[..., None, :], s[..., :, None] * Vt[..., :r, :]
        return (torch.from_numpy(np.ascontiguousarray(u)).to(like.device),
                torch.from_numpy(np.ascontiguousarray(v)).to(like.device))
    s = torch.from_numpy(np.sqrt(S[..., :r].astype(np.float64))).to(U)
    return ((U[..., :r] * s[..., None, :]).to(torch.float32).contiguous(),
            (s[..., :, None] * Vt[..., :r, :]).to(torch.float32).contiguous())


@dataclass
class LMFamily:
    """The reference's ``LMFamily`` over the port's LM decoder.
    Batches come from ``torch.Generator``s on the CPU (the reference's
    come from keys) and are placed on ``device``, where :meth:`init`,
    :meth:`add_exits` and the L pass's SVDs also run."""
    data: Any                           # SyntheticTokens
    seq: int = 128
    device: str = 'cuda'

    def __post_init__(self):
        _check_device(self.device)

    def _fwd(self, params, cfg, batch, collect=False):
        return tfm.forward(params, cfg, batch['tokens'],
                           collect_hiddens=collect)

    def generator(self, seed: int) -> torch.Generator:
        """The generator :meth:`init` and :meth:`add_exits` draw from, on
        ``device``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, gen: torch.Generator, cfg):
        return tfm.init_lm(gen, cfg, self.device)

    def train_batch(self, gen: torch.Generator, n):
        return self.data.batch(gen, n, self.seq, self.device)

    def logits_of(self, params, cfg, batch):
        return self._fwd(params, cfg, batch)

    def default_exit_points(self, cfg):
        _, G, _, _ = tfm.layer_groups(cfg)
        return tuple(sorted({G // 3, 2 * G // 3}))

    def exit_loss(self, params, cfg, batch):
        """(mean over the exit heads of their next-token cross entropy in
        fp32, exit logits)."""
        _, exits = self.exit_logits(params, cfg, batch)
        ce = 0.0
        for lg in exits.values():
            ce = ce + _token_ce(lg, batch['labels'])
        return ce / max(len(exits), 1), exits

    def loss(self, params, cfg, batch):
        """(mean next-token cross entropy in fp32, logits)."""
        lg = self._fwd(params, cfg, batch)
        return _token_ce(lg, batch['labels']), lg

    def eval_batches(self, n, batch, seed=10_000):
        """``n`` held-out batches, batch ``i`` drawn from generator seed
        ``seed + i``."""
        return [self.data.batch(torch.Generator().manual_seed(seed + i),
                                batch, self.seq, self.device)
                for i in range(n)]

    @torch.no_grad()
    def accuracy(self, params, cfg, batches):
        """Next-token top-1 accuracy (the LM analogue of classification
        acc)."""
        hit = tot = 0
        for b in batches:
            pred = torch.argmax(self._fwd(params, cfg, b), -1)
            hit += int(torch.sum(pred == b['labels']))
            tot += b['labels'].numel()
        return hit / tot

    # ----- distillation: a shallower student, rounded to the block pattern
    def shrink(self, cfg, factor):
        pat = len(cfg.block_pattern)
        n = max(pat, int(round(cfg.num_layers * factor / pat)) * pat)
        return cfg.replace(name=cfg.name + '-student', num_layers=n)

    # ----- pruning: d_ff channels, uniform across layers
    def prune(self, params, cfg, ratio):
        """Keep ``max(8, int(d_ff * (1 - ratio)))`` MLP channels by the
        importance ``sqrt(|wi|^2 + |wg|^2) * |wo|`` of each (summed in
        float64, so the card and the CPU keep the same channels): the
        sorted top channels of an unstacked layer; of a stacked ``(G, d,
        f)`` layer each group's own, in the reference's importance order
        (a stable argsort, as ``jnp.argsort``)."""
        if cfg.is_moe and cfg.n_experts > 2:
            return self._prune_experts(params, cfg, ratio)
        if not cfg.d_ff:
            return params, cfg
        if _any_factored(params):
            raise ValueError('cannot channel-prune low-rank-factored MLPs: '
                             'apply P before L')
        keep = max(8, int(cfg.d_ff * (1 - ratio)))

        def sq(w, dim):
            return torch.sum(torch.square(w.to(torch.float64)), dim=dim)

        def prune_mlp(mp, stacked):
            wi, wo = mp['wi']['w'], mp['wo']['w']
            col = sq(wi, -2) + (sq(mp['wg']['w'], -2) if 'wg' in mp else 0.0)
            imp = (torch.sqrt(col) * torch.sqrt(sq(wo, -1))).cpu().numpy()
            order = np.argsort(-imp, axis=-1, kind='stable')
            if stacked:
                idx = torch.from_numpy(order[..., :keep]).to(wi.device)

                def take_col(w):
                    return torch.take_along_dim(w, idx[:, None, :], dim=-1)

                def take_row(w):
                    return torch.take_along_dim(w, idx[..., None], dim=-2)
            else:
                idx = torch.from_numpy(np.sort(order[:keep])).to(wi.device)

                def take_col(w):
                    return w[..., idx]

                def take_row(w):
                    return w[..., idx, :]
            out = {'wi': {'w': take_col(wi)}, 'wo': {'w': take_row(wo)}}
            if 'wg' in mp:
                out['wg'] = {'w': take_col(mp['wg']['w'])}
            return out

        new = dict(params)
        for grp in ('prefix', 'blocks', 'tail'):
            new[grp] = [dict(lp, mlp=prune_mlp(lp['mlp'], grp == 'blocks'))
                        if 'mlp' in lp else lp for lp in params[grp]]
        return new, cfg.replace(d_ff=keep)

    def _prune_experts(self, params, cfg, ratio):
        """Keep ``max(top_k, int(E * (1 - ratio)))`` experts of every MoE
        layer by the importance of each, the norm of its router column
        (summed in float64): the sorted top experts of an unstacked layer;
        of a stacked ``(G, E, d, f)`` layer each group's own, in the
        reference's importance order (a stable argsort).  The router
        keeps the same columns; the shared expert stays whole."""
        keep = max(cfg.top_k, int(cfg.n_experts * (1 - ratio)))

        def prune_moe(mp, stacked):
            rw = mp['router']['w']                    # (..., d, E)
            imp = torch.sqrt(torch.sum(torch.square(rw.to(torch.float64)),
                                       dim=-2)).cpu().numpy()
            order = np.argsort(-imp, axis=-1, kind='stable')
            if stacked:
                idx = torch.from_numpy(order[..., :keep]).to(rw.device)
                r = torch.take_along_dim(rw, idx[:, None, :], dim=-1)

                def take(w):
                    return torch.take_along_dim(w, idx[:, :, None, None],
                                                dim=1)
            else:
                idx = torch.from_numpy(np.sort(order[:keep])).to(rw.device)
                r = rw[..., idx]

                def take(w):
                    return w[idx]
            return dict(mp, router={'w': r}, wi=take(mp['wi']),
                        wg=take(mp['wg']), wo=take(mp['wo']))

        new = dict(params)
        for grp in ('prefix', 'blocks', 'tail'):
            new[grp] = [dict(lp, moe=prune_moe(lp['moe'], grp == 'blocks'))
                        if 'moe' in lp else lp for lp in params[grp]]
        return new, cfg.replace(n_experts=keep)

    # ----- low-rank factorization (the L pass's family hook)
    def factorize(self, params, cfg, *, energy=0.95, min_rank=8):
        """SVD-split the dense MLP weights (wi, wg, wo); returns (params,
        cfg, mac_scale).  An unstacked layer factors per weight
        (:func:`_svd_split`, numpy on the host: deepseek-v3's leading dense
        layers); a stacked ``(G, d, f)`` weight with one
        shared rank, the largest of the groups' ranks (floored at
        ``min_rank``), so the stack stays rectangular, and only where that
        rank saves MACs.  Each factored weight becomes ``{'u': {'w'},
        'v': {'w'}}`` in fp32, as the reference's.  MoE expert tensors,
        the shared expert and the attention projections stay unfactored
        (only ``lp['mlp']`` is factored) and count in the cost.
        ``mac_scale`` is the whole tree's weight-volume ratio."""
        old_cost = _linear_cost(params)

        def tensor(a, like):
            return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)

        def factor_w(wp):
            w = wp['w']
            uv = _svd_split(w.detach().cpu().to(torch.float32).numpy(),
                            energy, min_rank)
            if uv is None:
                return wp
            return {'u': {'w': tensor(uv[0], w)}, 'v': {'w': tensor(uv[1], w)}}

        def factor_stacked(wp):
            w = wp['w']
            _, d, f = w.shape
            U, S, Vt = _lm_svd(w)
            tot = np.sum(S ** 2, axis=-1, keepdims=True)
            if not np.all(tot > 0):
                return wp
            ranks = (np.cumsum(S ** 2, axis=-1) < energy * tot).sum(-1) + 1
            r = int(min(max(int(ranks.max()), min_rank), S.shape[-1]))
            if r * (d + f) >= d * f:
                return wp
            u, v = _balanced(U, S, Vt, r, w)
            return {'u': {'w': u}, 'v': {'w': v}}

        def factor_mlp(mp, stacked):
            fn = factor_stacked if stacked else factor_w
            return {k: fn(wp) if k in ('wi', 'wg', 'wo') else wp
                    for k, wp in mp.items()}

        new = dict(params)
        for grp in ('prefix', 'blocks', 'tail'):
            new[grp] = [dict(lp, mlp=factor_mlp(lp['mlp'], grp == 'blocks'))
                        if 'mlp' in lp else lp for lp in params[grp]]
        return new, cfg, _linear_cost(new) / max(old_cost, 1.0)

    # ----- early exit: heads after scan groups
    def add_exits(self, gen: torch.Generator, params, cfg, groups):
        """A fresh head after each scan group in ``groups``: an RMS norm
        and a ``d x d`` adapter in the model's dtype, drawn from ``gen``
        in order; the unembedding is shared with the final head."""
        dtype = tfm.torch_dtype(cfg.dtype)
        kw = dict(dtype=dtype, device=self.device)
        params = dict(params)
        params['exit_heads'] = {
            str(g): {'norm': init_norm(cfg.d_model, **kw),
                     'adapter': init_dense(gen, cfg.d_model, cfg.d_model,
                                           **kw)}
            for g in groups}
        return params, cfg.replace(exit_layers=tuple(groups))

    def exit_logits(self, params, cfg, batch):
        """(final logits, ``{group: exit logits}``): each head reads the
        residual stream after its group, ``rms_norm(h + adapter(h))``, and
        the shared unembedding (softcapped as the final head)."""
        lg, hiddens = self._fwd(params, cfg, batch, collect=True)
        quant = (cfg.w_bits, cfg.a_bits)
        out = {}
        for g_str, hp in params.get('exit_heads', {}).items():
            g = int(g_str)
            h = hiddens[g]
            h = rms_norm(hp['norm'], h + dense(hp['adapter'], h, quant=quant),
                         cfg.norm_eps)
            elg = unembed(params.get('unembed', params['embed']), h,
                          quant=quant)
            out[g] = softcap(elg, cfg.logit_softcap)
        return lg, out

    @torch.no_grad()
    def exit_stats(self, params, cfg, batches, threshold):
        """(accuracy, exit_probs) of the dynamic early-exit model: a token
        leaves at the first head whose fp32 softmax maximum exceeds
        ``threshold``; ``exit_probs[g]`` is the share of the tokens that
        reach head ``g`` and leave there.  The rule runs on the device,
        the counts are read once a batch."""
        probs = {g: [0, 0] for g in cfg.exit_layers}
        hit = tot = 0
        with jitted_scales(), full_fp32():
            for b in batches:
                final, exits = self.exit_logits(params, cfg, b)
                y = b['labels'].reshape(-1)
                alive = torch.ones(y.shape, dtype=torch.bool,
                                   device=y.device)
                pred = torch.argmax(final, -1).reshape(-1)
                counts = []
                for g in sorted(cfg.exit_layers):
                    p = torch.softmax(exits[g].to(torch.float32), dim=-1
                                      ).reshape(-1, cfg.vocab_size)
                    conf = p.amax(-1) > threshold
                    take = alive & conf
                    counts += [take.sum(), alive.sum()]
                    pred = torch.where(take, p.argmax(-1), pred)
                    alive &= ~conf
                counts.append(torch.sum(pred == y))
                counts = torch.stack(counts).tolist()
                for i, g in enumerate(sorted(cfg.exit_layers)):
                    probs[g][0] += counts[2 * i]
                    probs[g][1] += counts[2 * i + 1]
                hit += counts[-1]
                tot += y.numel()
        return hit / tot, {g: c / max(n, 1) for g, (c, n) in probs.items()}

    # ----- costs
    def bitops(self, cfg, exit_probs=None, mac_scale=1.0):
        # exit indices are scan-group indices -> convert to layer indices
        ep = None
        if exit_probs:
            P = len(cfg.block_pattern)
            ep = {cfg.first_dense_layers + (g + 1) * P - 1: p
                  for g, p in exit_probs.items()}
        return bo.lm_bitops(cfg, self.seq, exit_probs=ep) * mac_scale

    def storage_bits(self, params, cfg):
        return bo.param_storage_bits(params, cfg.w_bits)


def _token_ce(logits, labels):
    """Mean next-token cross entropy of ``logits`` (B, S, vocab) in fp32."""
    return -torch.mean(torch.gather(
        torch.log_softmax(logits.to(torch.float32), dim=-1), -1,
        labels[..., None]))
