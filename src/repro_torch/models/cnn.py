"""CIFAR-style CNN family (ResNet / VGG / MobileNetV2) in PyTorch, on the
reference's layout: activations NHWC, conv weights HWIO, dense weights
(K, N), and the same nested dict/list parameter tree, so parameters cross
between the packages through numpy with no transposes.  Tensors are
permuted to NCHW/OIHW only inside the conv call.

As in the reference, BatchNorm is GroupNorm(8), every conv/fc routes
through the fake-quant hooks (cfg.w_bits / cfg.a_bits), and early-exit
heads hang off stage boundaries (cfg.exit_stages).  ``init_cnn`` draws
from a ``torch.Generator``, so its weights differ from the reference's
``jax.random`` draws; tests share weights through ``repro_torch.interop``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import fake_quant_act, fake_quant_weight
from repro_torch.kernels.ref import conv2d_same_nhwc


def _conv_init(gen, kh, kw, cin, cout, device):
    fan = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen) * math.sqrt(2.0 / fan)
    return {'w': w.to(device), 'b': torch.zeros((cout,), device=device)}


def conv(p, x, *, stride=1, quant=(0, 0), groups=1, name=None):
    """QAT/fp32 SAME conv with per-call fake-quant hooks on weight and
    activation (the training and calibration path; export swaps it through
    cnn_forward's ``conv_fn``).  A low-rank-factored conv ({'u', 'v'})
    chains the two sub-convs."""
    del name
    if 'u' in p:
        h = conv(p['u'], x, stride=stride, quant=quant, groups=groups)
        return conv(p['v'], h, quant=quant)
    w_bits, a_bits = quant
    w = p['w']
    if w_bits:
        w = fake_quant_weight(w, w_bits, axis=-1)
    if a_bits:
        x = fake_quant_act(x, a_bits)
    y = conv2d_same_nhwc(x, w.to(x.dtype), stride, groups)
    return y + p['b'].to(y.dtype)


def out_channels(p) -> int:
    """Output channels of a conv/fc param dict (fp32 'w', int8 'w_q', or
    low-rank factored {'u','v'} — the 'v' half carries the output dim)."""
    if 'v' in p and 'w' not in p and 'w_q' not in p:
        return out_channels(p['v'])
    return (p['w'] if 'w' in p else p['w_q']).shape[-1]


def group_norm(p, x, groups=8, eps=1e-5):
    """GroupNorm over NHWC with the population variance (``correction=0``,
    as ``jnp.var``)."""
    B, H, W, C = x.shape
    g = math.gcd(groups, C)
    xg = x.reshape(B, H, W, g, C // g)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, H, W, C) * p['scale'] + p['bias']


def _norm_init(c, device):
    return {'scale': torch.ones((c,), device=device),
            'bias': torch.zeros((c,), device=device)}


def _fc_init(gen, din, dout, device):
    w = torch.randn((din, dout), generator=gen) * math.sqrt(1.0 / din)
    return {'w': w.to(device), 'b': torch.zeros((dout,), device=device)}


def fc(p, x, *, quant=(0, 0), name=None):
    del name
    if 'u' in p:                   # low-rank factored: two chained matmuls
        return fc(p['v'], fc(p['u'], x, quant=quant), quant=quant)
    w_bits, a_bits = quant
    w = p['w']
    if w_bits:
        w = fake_quant_weight(w, w_bits, axis=-1)
    if a_bits:
        x = fake_quant_act(x, a_bits)
    y = x @ w.to(x.dtype)
    return y + p['b'].to(x.dtype) if 'b' in p else y


# ------------------------------------------------------------------------ init


def init_cnn(gen, cfg, device='cpu'):
    """Random parameters for ``cfg`` drawn from the CPU ``torch.Generator``
    ``gen`` and placed on ``device``."""
    def cv(kh, kw, cin, cout):
        return _conv_init(gen, kh, kw, cin, cout, device)

    p = {'stem': cv(3, 3, cfg.in_channels, cfg.stage_widths[0]),
         'stem_norm': _norm_init(cfg.stage_widths[0], device)}
    stages = []
    cin = cfg.stage_widths[0]
    for s, (n, w) in enumerate(zip(cfg.stage_blocks, cfg.stage_widths)):
        blocks = []
        for b in range(n):
            stride = 2 if (b == 0 and s > 0) else 1
            if cfg.kind == 'resnet':
                blk = {'conv1': cv(3, 3, cin, w), 'n1': _norm_init(w, device),
                       'conv2': cv(3, 3, w, w), 'n2': _norm_init(w, device)}
                if stride != 1 or cin != w:
                    blk['proj'] = cv(1, 1, cin, w)
            elif cfg.kind == 'vgg':
                blk = {'conv1': cv(3, 3, cin, w), 'n1': _norm_init(w, device)}
            else:  # mobilenet inverted residual
                e = cin * cfg.expand_ratio
                blk = {'expand': cv(1, 1, cin, e), 'n1': _norm_init(e, device),
                       'dw': cv(3, 3, 1, e), 'n2': _norm_init(e, device),
                       'project': cv(1, 1, e, w), 'n3': _norm_init(w, device)}
            blocks.append(blk)
            cin = w
        stages.append(blocks)
    p['stages'] = stages
    p['head'] = _fc_init(gen, cin, cfg.num_classes, device)
    if cfg.exit_stages:
        p['exits'] = {str(s): _fc_init(gen, cfg.stage_widths[s],
                                       cfg.num_classes, device)
                      for s in cfg.exit_stages}
    return p


# -------------------------------------------------------------------- forward


_ACTS = {None: lambda x: x, 'relu': F.relu, 'relu6': F.relu6}


def norm_act(p, y, *, act=None, skip=None, name=None):
    """The inter-layer glue: GroupNorm -> (+skip) -> activation, fp32.
    Every tensor between conv layers passes exactly one ``glue_fn`` call,
    which is where the int8-resident export requantizes."""
    del name
    h = group_norm(p, y)
    if skip is not None:
        h = h + skip
    return _ACTS[act](h)


def global_pool(x):
    """Global average pool (B,H,W,C) -> (B,C) ahead of fc/exit heads."""
    return x.mean(dim=(1, 2))


def _block_forward(blk, x, kind, stride, quant, conv_fn, glue_fn, name=''):
    if kind == 'resnet':
        h = glue_fn(blk['n1'],
                    conv_fn(blk['conv1'], x, stride=stride, quant=quant,
                            name=f'{name}.conv1'),
                    act='relu', name=f'{name}.n1')
        y = conv_fn(blk['conv2'], h, quant=quant, name=f'{name}.conv2')
        skip = conv_fn(blk['proj'], x, stride=stride, quant=quant,
                       name=f'{name}.proj') if 'proj' in blk else x
        return glue_fn(blk['n2'], y, act='relu', skip=skip,
                       name=f'{name}.n2')
    if kind == 'vgg':
        return glue_fn(blk['n1'],
                       conv_fn(blk['conv1'], x, stride=stride, quant=quant,
                               name=f'{name}.conv1'),
                       act='relu', name=f'{name}.n1')
    # mobilenet
    e = out_channels(blk['expand'])
    h = glue_fn(blk['n1'], conv_fn(blk['expand'], x, quant=quant,
                                   name=f'{name}.expand'),
                act='relu6', name=f'{name}.n1')
    h = glue_fn(blk['n2'], conv_fn(blk['dw'], h, stride=stride, quant=quant,
                                   groups=e, name=f'{name}.dw'),
                act='relu6', name=f'{name}.n2')
    skip = x if (stride == 1
                 and x.shape[-1] == out_channels(blk['project'])) else None
    return glue_fn(blk['n3'], conv_fn(blk['project'], h, quant=quant,
                                      name=f'{name}.project'),
                   skip=skip, name=f'{name}.n3')


def cnn_forward(params, cfg, x, *, collect_exits=False, conv_fn=None,
                fc_fn=None, glue_fn=None, pool_fn=None, start_stage=0,
                stop_stage=None):
    """x: (B, H, W, C) -> logits (B, classes); optionally exit logits dict.

    ``conv_fn``/``fc_fn``/``glue_fn``/``pool_fn`` inject the layer
    implementations (default: the QAT fake-quant path); core/export.py
    injects the int8 serving layers over the same topology.  Each call
    site carries a stable ``name`` (``stem``, ``s{stage}b{block}.conv1``,
    ``exit{s}``, ``head``) that keys the export layer plan.

    ``start_stage=s > 0`` treats ``x`` as the carry that left stage
    ``s - 1`` and skips the stem and earlier stages; ``stop_stage=s``
    stops after stage ``s`` and returns ``(exits, h)`` without running the
    final head.  That split is what the serving scheduler resumes on.
    """
    conv_fn = conv_fn or conv
    fc_fn = fc_fn or fc
    glue_fn = glue_fn or norm_act
    pool_fn = pool_fn or global_pool
    quant = (cfg.w_bits, cfg.a_bits)
    if start_stage == 0:
        h = glue_fn(params['stem_norm'],
                    conv_fn(params['stem'], x, quant=quant, name='stem'),
                    act='relu', name='stem.norm')
    else:
        h = x                                     # carry from stage s-1
    exits = {}
    for s, blocks in enumerate(params['stages']):
        if s < start_stage:
            continue
        if stop_stage is not None and s > stop_stage:
            break
        for b, blk in enumerate(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            h = _block_forward(blk, h, cfg.kind, stride, quant, conv_fn,
                               glue_fn, name=f's{s}b{b}')
        if collect_exits and 'exits' in params and str(s) in params['exits']:
            feat = pool_fn(h)
            exits[s] = fc_fn(params['exits'][str(s)], feat, quant=quant,
                             name=f'exit{s}')
    if stop_stage is not None:
        return exits, h                           # mid-network segment
    feat = pool_fn(h)
    logits = fc_fn(params['head'], feat, quant=quant, name='head')
    if collect_exits:
        return logits, exits
    return logits
