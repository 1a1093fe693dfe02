"""Device-memory traffic accounting over a layer plan (the reference's
``analysis/traffic.py``: :func:`boundary_bytes` and
:func:`predicted_hbm_bytes`, copied, plus a ``'cuda'`` term set).

The ``op-traffic`` rule compares :func:`predicted_hbm_bytes` with
``backend='cuda'`` against the bytes one ``fn`` call of an export writes,
as ``analysis.walker`` records them.  The ``'cuda'`` terms are what the
port's int8-resident lowering writes, per element, on either device (the
kernel wrappers and the torch glue are the same code on the card and the
CPU):

* ``input``: the input's static requantize (``ref.requantize``: the fp32
  product, round and clamp, then the int8 codes), 13 bytes an element;
* ``boundary``: each kernel call's int8 output, and the int8 h of a
  chained low-rank pair (a fused pair keeps h in shared memory);
* ``patches``: the im2col of each non-depthwise conv, the SAME-padded
  int8 plane, the int8 patch matrix and (for ``quant_conv``) the fp32
  per-row scale vector; a chained pair's v half has its own;
* ``glue``: the GroupNorm glue's fp32 intermediates on each conv's output
  (the int8 codes as fp32, centred, normalized, scaled, shifted; the
  activation but after a MobileNet ``project``; the skip's dequantize and
  add after a ResNet ``conv2`` or a MobileNet ``project`` whose block keeps
  its shape; the fp32 requantize), 33-49 bytes an element, plus the
  group statistics; a ResNet ``proj`` feeds the glue of its block's
  ``conv2`` and has none;
* ``fc``: the head's global pool in fp32 (the codes as fp32, the mean,
  the scale), its requantize, the per-row scale vector(s) and the fp32
  logits (with the int8 h of a factored head).

Measured over predicted, exactly 1.000 on every clean export: on the CPU
those of ``analysis.gate`` and the tests (resnet8, vgg8, mobilenet-small
and factored resnet8; W8A8, exit heads, 2 and 4 images of 16 and 32
pixels), and on an H100 (chip_smoke.py's path (j), 32 images)
resnet34-cifar (1650.8 MB a call), mobilenetv2-cifar (717.8 MB),
factored resnet34-cifar (1651.8 MB) and the DPLQE chain's export of
resnet34-cifar (878.4 MB), each equal to the CPU's count of the same
export byte for byte.  The ``op-traffic`` rule errors above 1.2 (the
reference's 20%), so it fires on a traffic regression as small as one
extra fp32 copy of the largest activations.

The ``'pallas'`` and ``'jnp'`` terms are the reference's, kept as they
are: they describe the reference's lowerings.
"""
from __future__ import annotations

import math


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def boundary_bytes(plan_layers: dict) -> dict:
    """Inter-layer (HBM-boundary) traffic of the int8-resident path.

    Per layer: int8 input + output bytes, the output at 4 bytes/element for
    declared fp32 fallback layers only.  Depthwise layers' share is
    reported separately (``depthwise_bytes``) — this is exactly the
    roofline's ``memory_s_int8_resident`` numerator.
    """
    int8_bytes = dw_bytes = 0.0
    elems_in = elems_out = 0
    for e in plan_layers.values():
        out_b = 4.0 if e.get('fallback') else 1.0
        layer = _prod(e['in_shape']) + out_b * _prod(e['out_shape'])
        int8_bytes += layer
        if e.get('depthwise'):
            dw_bytes += layer
        elems_in += _prod(e['in_shape'])
        elems_out += _prod(e['out_shape'])
    return {'int8_bytes': int8_bytes, 'depthwise_bytes': dw_bytes,
            'elems_in': elems_in, 'elems_out': elems_out}


def _patch_elems(e) -> int:
    """im2col patch-matrix elements a non-depthwise conv materializes."""
    kh, kw = e.get('kernel', (1, 1))
    b, oh, ow = e['out_shape'][0], e['out_shape'][1], e['out_shape'][2]
    return b * oh * ow * kh * kw * e['in_shape'][-1]


def _im2col_bytes(in_shape, out_shape, kernel, stride, scales=True) -> int:
    """One im2col gather on the port: the SAME-padded int8 plane, the int8
    patch matrix and, for ``quant_conv``, the fp32 per-row scales."""
    b, h, w, c = in_shape
    kh, kw = kernel
    m = b * out_shape[1] * out_shape[2]
    hp = max((out_shape[1] - 1) * stride + kh, h)
    wp = max((out_shape[2] - 1) * stride + kw, w)
    return b * hp * wp * c + m * kh * kw * c + (4 * m if scales else 0)


def _glue_bytes(name, e, layers) -> int:
    """The GroupNorm glue after the conv ``name`` (see the module
    docstring); 0 for a ResNet ``proj``."""
    block, _, leaf = name.rpartition('.')
    if leaf == 'proj':
        return 0
    o = _prod(e['out_shape'])
    b, c = e['out_shape'][0], e['out_shape'][-1]
    per = 4 + 16 + 13 + (0 if leaf == 'project' else 4)
    if leaf == 'conv2' or (leaf == 'project' and e['out_shape']
                           == layers.get(f'{block}.expand',
                                         {}).get('in_shape')):
        per += 12
    return per * o + 16 * b * math.gcd(8, c)


def predicted_hbm_bytes(plan_layers: dict, backend: str = 'jnp') -> dict:
    """Predicted bytes one serving step of a resident export writes (see
    the module docstring for the per-backend terms).  Returns the total
    plus the term breakdown so a flagged regression names what grew."""
    first = next(iter(plan_layers.values()))
    n_in = float(_prod(first['in_shape']))
    total = 13 * n_in if backend == 'cuda' else n_in
    terms = {'input': total}

    def add(key, v):
        nonlocal total
        terms[key] = terms.get(key, 0.0) + float(v)
        total += v

    last = None
    for name, e in plan_layers.items():
        o = _prod(e['out_shape'])
        if e['kind'] == 'fc':
            if backend != 'cuda':
                # fp32 logits (+ the fp32 rank intermediate when factored)
                add('fc', 4 * o * (2 if e.get('factored') else 1))
                continue
            b, c = e['in_shape']
            pool = 4 * _prod(last['out_shape']) + 8 * b * c
            rank = e['macs'] // (c + e['out_shape'][-1])
            heads = 4 * b + (b * rank + 4 * b if e.get('factored') else 0)
            add('fc', pool + 13 * b * c + heads + 4 * o)
            continue
        last = e
        if backend == 'cuda':
            kernel, stride = e.get('kernel', (1, 1)), e.get('stride', 1)
            add('boundary', o)
            add('glue', _glue_bytes(name, e, plan_layers))
            if e.get('depthwise'):
                continue
            if e.get('factored') and not e.get('fused'):
                mid = e['out_shape'][:3] + (e['rank'],)
                add('boundary', _prod(mid))
                add('patches', _im2col_bytes(e['in_shape'], mid, kernel,
                                             stride))
                add('patches', _im2col_bytes(mid, e['out_shape'], (1, 1),
                                             1))
            else:
                add('patches', _im2col_bytes(e['in_shape'], e['out_shape'],
                                             kernel, stride,
                                             scales=not e.get('fused')))
        elif backend == 'pallas':
            out_b = 4 if e.get('fallback') else 1
            add('boundary', _prod(e['in_shape']) + out_b * o)
            if not (e.get('depthwise') or e.get('fallback')):
                add('patches', _patch_elems(e))
        else:
            # fp32 conv out + fp32 glue out + int8 requantized boundary
            add('conv', 9 * o)
            if e.get('depthwise'):
                add('depthwise_pad', 4 * _prod(e['in_shape']))
            if e.get('factored'):
                h = e['out_shape'][0] * e['out_shape'][1] \
                    * e['out_shape'][2] * e['rank']
                add('lowrank_h', 5 * h)      # fp32 h + int8 h_q
    return {'predicted_bytes': total, 'terms': terms, 'backend': backend}
