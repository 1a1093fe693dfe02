"""Family adapters: the uniform interface the compression passes use, over
CNNs and LMs (the reference's ``core/family.py``).

The passes are family-agnostic; everything model-specific lives here.
``CNNFamily`` is whole: the forward and the losses, distillation's student
(``shrink``), physical channel pruning (``prune``), the low-rank
factorization the L pass applies, exit heads and their dynamic statistics
(``exit_stats``), and the BitOps/storage costs.  ``LMFamily`` is the subset
the Q pass needs; its other chain hooks (``shrink``, ``prune``,
``factorize``, the exit heads and ``exit_stats``) raise until they are
ported (ROADMAP, queue A 1).

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
* ``prune``'s L2 channel importance is summed in float64 (the reference's
  in float32), so the card and the CPU keep the same channels; numpy's
  argsort picks them, as in the reference, which keeps the same channels
  except at a tie within fp32 rounding.
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


_LM_UNPORTED = ('default_exit_points', 'add_exits', 'exit_logits',
                'exit_loss', 'exit_stats', 'shrink', 'prune', 'factorize')


def _unported(what):
    raise NotImplementedError(f'LMFamily.{what} is not ported yet (ROADMAP, '
                              f'queue A 1: the LM chain hooks)')


@dataclass
class LMFamily:
    """The reference's ``LMFamily`` for the Q pass.  Batches come from
    ``torch.Generator``s on the CPU (the reference's come from keys) and
    are placed on ``device``, where :meth:`init` also draws the
    weights."""
    data: Any                           # SyntheticTokens
    seq: int = 128
    device: str = 'cuda'

    def __post_init__(self):
        _check_device(self.device)

    def _fwd(self, params, cfg, batch, collect=False):
        if collect:
            _unported('_fwd(collect=True)')
        return tfm.forward(params, cfg, batch['tokens'])

    def generator(self, seed: int) -> torch.Generator:
        """The generator :meth:`init` draws from, on ``device``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, gen: torch.Generator, cfg):
        return tfm.init_lm(gen, cfg, self.device)

    def train_batch(self, gen: torch.Generator, n):
        return self.data.batch(gen, n, self.seq, self.device)

    def logits_of(self, params, cfg, batch):
        return self._fwd(params, cfg, batch)

    def loss(self, params, cfg, batch):
        """(mean next-token cross entropy in fp32, logits)."""
        lg = self._fwd(params, cfg, batch)
        ce = -torch.mean(torch.gather(
            torch.log_softmax(lg.to(torch.float32), dim=-1), -1,
            batch['labels'][..., None]))
        return ce, lg

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

    def __getattr__(self, name):
        """The reference's other methods raise until they are ported."""
        if name in _LM_UNPORTED:
            _unported(name)
        raise AttributeError(name)
