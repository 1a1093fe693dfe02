"""Export a CNN to int8 serving on the port's kernels, in the reference's
two tiers (``core/export.py``):

1. **Dynamic scales** (``calibrate=None``): the weights become int8 once
   (static per-out-channel scales) and every layer quantizes its fp32
   input with one per-tensor abs-max (``ops.quant_conv_nhwc`` /
   ``ops.quant_dense``): a conv through im2col on the CUDA
   ``quant_matmul`` kernel, a depthwise conv on ``depthwise_conv``, a
   low-rank-factored pair as two such calls, the heads on
   ``quant_matmul``; fp32 activations travel between layers.
2. **Int8-resident** (``calibrate=<sample batch>``): a *layer-plan
   compiler* runs one calibration forward (the QAT fake-quant math) over
   the batch and records a static activation scale at every layer
   boundary (:class:`LayerPlan`).  The plan's layers serve on the int8
   kernels, each with the requantize epilogue, so activations travel
   between layers as int8 :class:`QAct` on static scales: a plain conv
   through ``quant_conv`` (im2col + ``quant_matmul``); a depthwise conv
   (MobileNet's ``dw``) on ``depthwise_conv``; a low-rank-factored conv
   pair either in one launch of the CUDA ``lowrank_conv`` kernel
   (``fused``, when its rank fits the kernel's envelope and kernel
   selection picks it) or as two ``quant_conv`` launches (``chained``);
   the exit and final heads through ``quant_matmul`` with fp32 output (a
   factored head chains two).  The glue (GroupNorm + skip + act) runs on
   the raw int8 codes in fp32 and requantizes to the consumer's scale.

Both tiers store every weight they send to ``quant_matmul`` or
``lowrank_conv`` K-major (:func:`k_major`), the layout their TMA +
``wgmma`` routes read, and split at the exit heads into stage segments
that the serving scheduler resumes on (the dynamic tier's carry is fp32),
served with batched early exit.

One lowering serves both devices: the kernel wrappers launch the CUDA
kernels for tensors on the card and run their plain versions for CPU
tensors (the reference's separate jnp lowering with folded scales is
not needed for that; ``ServingModel.backend`` names which ran).  Measure
mode (``select_kernels='measure'``) races the two low-rank lowerings on
the export's device: CUDA events on the card, ``perf_counter`` on the
CPU (where it times the plain versions).  ``verify=`` runs the analyzer
(``repro_torch.analysis``) over the fresh export.  A grouped conv with
per-group depth > 1 (no configuration has one) is the reference's declared
fp32 fallback at both tiers: its plan entry says ``'fallback'`` with no
launch, and it serves as ``ref.quant_conv_ref`` on the dequantized
operands (``F.conv2d`` with ``groups``), int8 in and fp32 out, the next
glue requantizing, as the reference serves it through ``lax.conv``.

:func:`export_lm` is the LM family's int8 weight export.
:func:`export_chain` exports a finished compression chain through a
per-family serving-backend registry (:func:`register_serving_backend`),
as the reference does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.core.quantization import (full_fp32, jitted_scales,
                                          quantize_params_for_serving)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.depthwise_conv import fits_depthwise
from repro_torch.kernels.lowrank_conv import (LAUNCH_US, fits_fused,
                                              lowering_costs)
from repro_torch.models import cnn as cnn_lib

SELECT_KERNELS = ('model', 'fused', 'measure')


def _serving_bits(cfg) -> tuple[int, int]:
    """(w_bits, a_bits) the int8 kernels run at: the chain's QAT bits when
    they fit in int8, else 8."""
    w_bits = cfg.w_bits if 0 < cfg.w_bits <= 8 else 8
    a_bits = cfg.a_bits if 1 < cfg.a_bits <= 8 else 8
    return w_bits, a_bits


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA on a host
    without a card (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: this entry point runs on the card '
                           "unless the caller asks for device='cpu'")
    return device


def _indexed(device) -> torch.device:
    """``device`` as a torch.device, a bare ``cuda`` as the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def to_device(tree, device):
    """Move every tensor of a nested dict/list/tuple tree to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


# --------------------------------------------------------- dynamic scales


def _serving_layers(a_bits: int):
    """Dynamic-scale int8 layer implementations injected into cnn_forward.

    Weight scales live in the params tree (static); ``quant`` is the QAT
    hook tuple, ignored here.  Low-rank factored params (``{'u','v'}``,
    each half int8 after ``quantize_params_for_serving``) chain two
    kernel calls, as the QAT forward chains two convs."""
    def conv_fn(p, x, *, stride=1, quant=(0, 0), groups=1, name=None):
        del quant, name
        if 'u' in p:
            h = conv_fn(p['u'], x, stride=stride, groups=groups)
            return conv_fn(p['v'], h)
        return ops.quant_conv_nhwc(x, p['w_q'], p['scale'], p.get('b'),
                                   stride=stride, groups=groups,
                                   a_bits=a_bits)

    def fc_fn(p, x, *, quant=(0, 0), name=None):
        del quant, name
        if 'u' in p:
            return fc_fn(p['v'], fc_fn(p['u'], x))
        y = ops.quant_dense(x, p['w_q'], p['scale'], a_bits=a_bits,
                            per_row=False)
        return y + p['b'] if 'b' in p else y

    return conv_fn, fc_fn


# ------------------------------------------------ int8-resident layer plan


@dataclass(frozen=True)
class QAct:
    """An int8 activation travelling between layers with its static scale.

    ``scale`` is a Python float captured at export calibration and never
    recomputed at serve time; device memory sees the int8 ``q`` alone."""
    q: Any
    scale: float

    @property
    def shape(self):
        return self.q.shape


def _deq(x):
    """Dequantize (identity on tensors already fp32)."""
    if isinstance(x, QAct):
        return x.q.to(torch.float32) * x.scale
    return x


@dataclass
class LayerPlan:
    """The layer-plan compiler's output: per-layer static scales and kernel
    choice, keyed by the stable layer names of models/cnn.py.  ``layers``
    covers convs/fcs, ``glues`` the inter-layer norm/act boundaries."""
    layers: dict
    glues: dict
    a_qmax: float

    def summary(self) -> dict:
        """Deployed-cost summary: MACs, launch counts, the MAC fraction
        served by the fp32 fallback, the depthwise and
        low-rank layer counts, and the per-layer fused-vs-chained selection
        with its reason.  Counts cover the plain serving path
        (``ServingModel.fn``); the exit heads, executed only by
        ``fn_exits``, are reported as ``n_exit_heads`` /
        ``exit_head_launches``."""
        main = {n: e for n, e in self.layers.items()
                if not n.startswith('exit')}
        exits = {n: e for n, e in self.layers.items()
                 if n.startswith('exit')}
        total = sum(e['macs'] for e in main.values())
        fallback = sum(e['macs'] for e in main.values() if e['fallback'])
        return {
            'n_layers': len(main),
            'n_fused_lowrank': sum(1 for e in main.values()
                                   if e.get('fused')),
            'n_chained_lowrank': sum(1 for e in main.values()
                                     if e.get('factored')
                                     and not e.get('fused')),
            'n_depthwise': sum(1 for e in main.values()
                               if e.get('depthwise')),
            'n_fallback': sum(1 for e in main.values() if e['fallback']),
            'kernel_launches': sum(e['launches'] for e in main.values()),
            'n_exit_heads': len(exits),
            'exit_head_launches': sum(e['launches'] for e in exits.values()),
            'total_macs': total,
            'fallback_mac_fraction': fallback / max(total, 1),
            'lowrank_selection': {n: e['selection'] for n, e in main.items()
                                  if e.get('selection')},
            'lowering_cost_delta': self._lowering_cost_delta(main),
        }

    @staticmethod
    def _lowering_cost_delta(main) -> dict:
        """Measured-vs-modeled lowering costs for every layer that a
        measure-mode export timed (empty otherwise): how far off the cost
        model ``lowering_costs`` was from the measurement, and whether both
        agree on the fused/chained winner."""
        out = {}
        for n, e in main.items():
            sel = e.get('selection') or {}
            if 'modeled_fused_us' not in sel or 'fused_us' not in sel:
                continue
            model_choice = ('fused' if sel['modeled_fused_us']
                            <= sel['modeled_chained_us'] else 'chained')
            out[n] = {
                'measured_fused_us': round(sel['fused_us'], 1),
                'measured_chained_us': round(sel['chained_us'], 1),
                'modeled_fused_us': round(sel['modeled_fused_us'], 1),
                'modeled_chained_us': round(sel['modeled_chained_us'], 1),
                'fused_measured_over_modeled': round(
                    sel['fused_us'] / max(sel['modeled_fused_us'], 1e-9), 3),
                'chained_measured_over_modeled': round(
                    sel['chained_us'] / max(sel['modeled_chained_us'],
                                            1e-9), 3),
                'model_agrees': model_choice == sel['choice'],
            }
        return out


def _select_lowering(m, k1, r, cout, *, fuse_lowrank, select_kernels,
                     launch_us=LAUNCH_US):
    """Fused or chained for one factored conv, and why (``launch_us``: the
    cost model's per-launch term)."""
    if not fits_fused(r, cout):
        return {'choice': 'chained',
                'why': f'rank {r} exceeds the fused envelope'}
    if not fuse_lowrank:
        return {'choice': 'chained',
                'why': 'fuse_lowrank=False (forced two-launch A/B)'}
    if select_kernels == 'fused':
        return {'choice': 'fused', 'why': 'select_kernels=fused (forced)'}
    c = lowering_costs(m, k1, r, cout, launch_us=launch_us)
    return {'choice': 'fused' if c['fused_us'] <= c['chained_us']
            else 'chained',
            'why': (f"modeled fused {c['fused_us']:.1f}us vs chained "
                    f"{c['chained_us']:.1f}us"),
            'fused_us': c['fused_us'], 'chained_us': c['chained_us']}


def _compile_layer_plan(params, cfg, x, a_qmax, fuse_lowrank=True,
                        select_kernels='model', record=None) -> LayerPlan:
    """One calibration forward (the QAT fake-quant math) that records a
    static activation scale at every layer boundary and picks the serving
    kernel per layer: plain, depthwise, or a factored pair fused or
    chained (:func:`_select_lowering`; ``'model'`` prices both with the
    H100 cost model ``lowering_costs`` at the calibration geometry,
    ``'fused'`` forces one launch, ``fuse_lowrank=False`` forces two;
    ``'measure'`` is priced as ``'model'`` here and re-decided by
    :func:`_measure_lowrank_selection`).
    ``record`` (a list) receives ``(name, key, tensor)`` for every scale in
    forward order (:func:`calibration_tensors`)."""
    layers, glues = {}, {}

    def scale(name, key, v) -> float:
        if record is not None:
            record.append((name, key, v))
        return max(float(torch.abs(v).amax()), 1e-8) / a_qmax

    def conv_fn(p, cx, *, stride=1, quant=(0, 0), groups=1, name=None):
        factored = 'u' in p
        depthwise = groups > 1 and not factored and fits_depthwise(
            p['w'].shape)
        e = {'sx': scale(name, 'sx', cx), 'kind': 'conv',
             'fallback': groups > 1 and not depthwise,
             'depthwise': depthwise, 'factored': factored, 'fused': False,
             'stride': stride, 'in_shape': tuple(cx.shape), 'groups': groups,
             'w_shape': None if factored else tuple(p['w'].shape)}
        if factored:
            mid = cnn_lib.conv(p['u'], cx, stride=stride, quant=quant,
                               groups=groups)
            e['h_scale'] = scale(name, 'h_scale', mid)
            y = cnn_lib.conv(p['v'], mid, quant=quant)
            kh, kw, cin, r = p['u']['w'].shape
            cout = p['v']['w'].shape[-1]
            oh, ow = y.shape[1], y.shape[2]
            e['macs'] = oh * ow * r * (kh * kw * cin + cout)
            e['selection'] = _select_lowering(
                y.shape[0] * oh * ow, kh * kw * cin, r, cout,
                fuse_lowrank=fuse_lowrank, select_kernels=select_kernels)
            e['fused'] = e['selection']['choice'] == 'fused'
            e['launches'] = 1 if e['fused'] else 2
            e['rank'] = r
        else:
            y = cnn_lib.conv(p, cx, stride=stride, quant=quant,
                             groups=groups)
            kh, kw, cin, cout = p['w'].shape
            oh, ow = y.shape[1], y.shape[2]
            e['macs'] = oh * ow * kh * kw * cin * cout
            e['launches'] = 0 if e['fallback'] else 1
        e['kernel'] = (kh, kw)
        e['out_scale'] = scale(name, 'out_scale', y)
        e['out_shape'] = tuple(y.shape)
        layers[name] = e
        return y

    def fc_fn(p, cx, *, quant=(0, 0), name=None):
        e = {'sx': scale(name, 'sx', cx), 'kind': 'fc', 'fallback': False,
             'factored': 'u' in p, 'fused': False, 'out_scale': None,
             'in_shape': tuple(cx.shape)}
        if 'u' in p:
            mid = cnn_lib.fc(p['u'], cx, quant=quant)
            e['h_scale'] = scale(name, 'h_scale', mid)
            y = cnn_lib.fc(p['v'], mid, quant=quant)
            din, r = p['u']['w'].shape
            e['macs'] = r * (din + p['v']['w'].shape[-1])
            e['launches'] = 2
        else:
            y = cnn_lib.fc(p, cx, quant=quant)
            e['macs'] = p['w'].shape[0] * p['w'].shape[1]
            e['launches'] = 1
        e['out_shape'] = tuple(y.shape)
        layers[name] = e
        return y

    def glue_fn(np_, y, *, act=None, skip=None, name=None):
        h = cnn_lib.norm_act(np_, y, act=act, skip=skip)
        glues[name] = scale(name, 'glue', h)
        return h

    cnn_lib.cnn_forward(params, cfg, x, collect_exits=True, conv_fn=conv_fn,
                        fc_fn=fc_fn, glue_fn=glue_fn)
    return LayerPlan(layers=layers, glues=glues, a_qmax=a_qmax)


def calibration_tensors(params, cfg, x) -> list:
    """The calibration forward's scale sources, in forward order, on the
    device of ``x``: ``(name, key, fp32 tensor)`` with ``key`` the plan
    entry the tensor's abs-max sets (a layer's ``'sx'``, ``'h_scale'`` or
    ``'out_scale'``, or ``'glue'`` for ``plan.glues[name]``).  The ``'sx'``
    and ``'h_scale'`` tensors are the activations the forward
    fake-quantizes, so two exports' plans can be compared code by code."""
    record = []
    a_qmax = 2.0 ** (_serving_bits(cfg)[1] - 1) - 1.0
    with full_fp32(), torch.no_grad():
        _compile_layer_plan(to_device(params, x.device), cfg, x, a_qmax,
                            record=record)
    return record


def compare_calibrations(a: list, b: list, a_qmax: float = 127.0) -> dict:
    """Two calibration forwards of one model on one batch (records of
    :func:`calibration_tensors`, on any devices), in forward order.

    Returns ``rel``, each scale's relative difference, and ``flip``, the
    index of the first fake-quantized activation (``'sx'`` or
    ``'h_scale'``) whose codes differ, or None.  At that activation:
    ``at`` (name and key), ``codes`` that differ of ``of``, ``step`` the
    largest code change, and ``tie`` the largest distance of a differing
    code's x/scale from a rounding tie (k + 0.5), on the nearer side.  The
    codes are ``fake_quant_act``'s, computed on the CPU: the same IEEE
    divisions every device runs."""
    if [r[:2] for r in a] != [r[:2] for r in b]:
        raise ValueError('the two calibration forwards differ in order')

    def codes(v):
        s = ref.true_div(torch.clamp_min(v.abs().amax(), 1e-8), a_qmax)
        t = v / s
        return torch.clamp(torch.round(t), -a_qmax - 1.0, a_qmax), t

    out = {'rel': [], 'flip': None}
    for i, ((name, key, u), (_, _, v)) in enumerate(zip(a, b)):
        u, v = u.detach().cpu(), v.detach().cpu()
        su = max(float(u.abs().amax()), 1e-8)
        sv = max(float(v.abs().amax()), 1e-8)
        out['rel'].append(abs(su - sv) / sv)
        if out['flip'] is not None or key not in ('sx', 'h_scale'):
            continue
        (cu, tu), (cv, tv) = codes(u), codes(v)
        differ = cu != cv
        if bool(differ.any()):
            tie = torch.minimum((tu - torch.floor(tu) - 0.5).abs(),
                                (tv - torch.floor(tv) - 0.5).abs())[differ]
            out.update(flip=i, at=f'{name} {key}', codes=int(differ.sum()),
                       of=differ.numel(),
                       step=float((cu - cv).abs().max()),
                       tie=float(tie.max()))
    return out


def layer_kernel_launches(e) -> dict:
    """``{kernel: launches}`` one plan entry makes per batch."""
    if e.get('depthwise'):
        return {'depthwise_conv': 1}
    if e.get('fused'):
        return {'lowrank_conv': 1}
    return {'quant_matmul': e['launches']}


def _resolve_layer_params(params, name: str):
    """Map a stable layer name from models/cnn.py (``s0b1.conv2``,
    ``stem``, ``exit1``, ``head``) to its param subtree."""
    head = name.split('.')[0]
    if head == 'stem':
        return params['stem']
    if head == 'head':
        return params['head']
    if head.startswith('exit'):
        return params['exits'][head[4:]]
    s, b = head[1:].split('b')
    return params['stages'][int(s)][int(b)][name.split('.')[1]]


def _bias_or_zeros(p):
    b = p.get('b')
    if b is None:
        b = torch.zeros(p['w_q'].shape[-1], dtype=torch.float32,
                        device=p['w_q'].device)
    return b


def time_us(fn, device) -> float:
    """Microseconds of one call of ``fn``: CUDA events around it on the
    card, ``perf_counter`` on the CPU."""
    if device.type == 'cuda':
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e6


def _measure_lowrank_selection(plan: LayerPlan, qparams, device, *,
                               reps: int = 3, tracer=None) -> None:
    """Resolve ``select_kernels='measure'``: time fused against chained.

    For every factored conv inside the fused envelope, times both lowerings
    on ``device`` (a zero int8 input at the calibration geometry — the
    kernels' time does not depend on the data — best of ``reps`` after a
    warm-up call): fused is one ``lowrank_conv`` launch, chained two
    ``quant_matmul`` launches.  Rewrites ``e['selection']`` /
    ``e['fused']`` with the measured winner, in place.  The cost model's
    prices stay beside the measurement as ``modeled_fused_us`` /
    ``modeled_chained_us`` (the summary's ``lowering_cost_delta``), and
    each timed launch lands on ``tracer`` as a ``kernel.launch`` span on
    track ``export`` with its ``variant``: the spans ARE the measurement
    the decision is made from.  ``qparams`` must already be K-major."""
    from repro_torch.obs.trace import as_tracer
    tracer = as_tracer(tracer)
    qmax = plan.a_qmax
    for name, e in plan.layers.items():
        if e['kind'] != 'conv' or not e['factored']:
            continue
        if e['selection']['choice'] == 'chained' and 'envelope' in \
                e['selection']['why']:
            continue                     # rank-ineligible: nothing to race
        p = _resolve_layer_params(qparams, name)
        u, v = p['u'], p['v']
        bu, bv = _bias_or_zeros(u), _bias_or_zeros(v)
        xq = torch.zeros(e['in_shape'], dtype=torch.int8, device=device)

        def fused():
            return ops.lowrank_conv_nhwc(
                xq, u['w_q'], v['w_q'], u['scale'], v['scale'], bu, bv,
                sx=e['sx'], h_scale=e['h_scale'], stride=e['stride'],
                out_scale=e['out_scale'], h_qmax=qmax, out_qmax=qmax)

        def chained():
            h = ops.quant_conv_static(
                xq, u['w_q'], u['scale'], bu, sx=e['sx'], stride=e['stride'],
                out_scale=e['h_scale'], out_qmax=qmax)
            return ops.quant_conv_static(
                h, v['w_q'], v['scale'], bv, sx=e['h_scale'],
                out_scale=e['out_scale'], out_qmax=qmax)

        def best_us(f, variant):
            f()                          # warm-up: build and load first
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            ts = []
            for rep in range(reps):
                w0 = tracer.now()
                us = time_us(f, device)
                tracer.add('kernel.launch', w0, w0 + us * 1e-6,
                           track='export', layer=name, variant=variant,
                           rep=rep, us=round(us, 1))
                ts.append(us)
            return min(ts)

        modeled = e['selection']          # the cost model's, before the race
        tf = best_us(fused, 'fused')
        tc = best_us(chained, 'chained')
        e['selection'] = {'choice': 'fused' if tf <= tc else 'chained',
                          'why': (f'measured fused {tf:.0f}us vs chained '
                                  f'{tc:.0f}us'),
                          'fused_us': tf, 'chained_us': tc}
        if 'fused_us' in modeled:         # keep the model's claim on record
            e['selection']['modeled_fused_us'] = modeled['fused_us']
            e['selection']['modeled_chained_us'] = modeled['chained_us']
        e['fused'] = tf <= tc
        e['launches'] = 1 if e['fused'] else 2


def _resident_layers(plan: LayerPlan):
    """Int8-resident layer implementations compiled from a LayerPlan.

    Convs consume and produce :class:`QAct`: int8 on static scales, the
    requantize epilogue in the kernel.  The glue normalizes the raw int8
    codes (GroupNorm is invariant to the positive per-tensor scale, up to
    eps) and requantizes to its calibrated output scale, which equals the
    consumer's input scale by construction."""
    qmax = plan.a_qmax

    def as_qact(x, sx):
        if isinstance(x, QAct):
            return x
        return QAct(ref.requantize(x, sx, qmax), sx)

    def conv_fn(p, x, *, stride=1, quant=(0, 0), groups=1, name=None):
        del quant
        e = plan.layers[name]
        xq = as_qact(x, e['sx'])
        if e['fallback']:                 # fp32 out; the next glue requantizes
            return ref.quant_conv_ref(xq.q, p['w_q'], xq.scale, p['scale'],
                                      p.get('b'), stride=stride,
                                      groups=groups)
        kw = dict(out_scale=e['out_scale'], out_qmax=qmax)
        if e['depthwise']:
            y = ops.depthwise_conv_static(
                xq.q, p['w_q'], p['scale'], p.get('b'), sx=xq.scale,
                stride=stride, **kw)
        elif e['fused']:
            u, v = p['u'], p['v']
            y = ops.lowrank_conv_nhwc(
                xq.q, u['w_q'], v['w_q'], u['scale'], v['scale'],
                _bias_or_zeros(u), _bias_or_zeros(v), sx=xq.scale,
                h_scale=e['h_scale'], stride=stride, h_qmax=qmax, **kw)
        elif e['factored']:
            u, v = p['u'], p['v']
            h = ops.quant_conv_static(
                xq.q, u['w_q'], u['scale'], _bias_or_zeros(u), sx=xq.scale,
                stride=stride, out_scale=e['h_scale'], out_qmax=qmax)
            y = ops.quant_conv_static(h, v['w_q'], v['scale'],
                                      _bias_or_zeros(v), sx=e['h_scale'],
                                      **kw)
        else:
            y = ops.quant_conv_static(
                xq.q, p['w_q'], p['scale'], p.get('b'), sx=xq.scale,
                stride=stride, **kw)
        return QAct(y, e['out_scale'])

    def fc_fn(p, x, *, quant=(0, 0), name=None):
        del quant
        e = plan.layers[name]
        xq = ref.requantize(_deq(x), e['sx'], qmax)
        if e['factored']:
            h = ops.quant_dense_static(
                xq, p['u']['w_q'], p['u']['scale'], p['u'].get('b'),
                sx=e['sx'], out_scale=e['h_scale'], out_qmax=qmax)
            return ops.quant_dense_static(
                h, p['v']['w_q'], p['v']['scale'], p['v'].get('b'),
                sx=e['h_scale'])
        return ops.quant_dense_static(xq, p['w_q'], p['scale'], p.get('b'),
                                      sx=e['sx'])

    def glue_fn(np_, y, *, act=None, skip=None, name=None):
        s = plan.glues[name]
        h = cnn_lib.group_norm(
            np_, y.q.to(torch.float32) if isinstance(y, QAct) else y)
        if skip is not None:
            h = h + _deq(skip)
        h = cnn_lib._ACTS[act](h)
        return QAct(ref.requantize(h, s, qmax), s)

    def pool_fn(h):
        if isinstance(h, QAct):           # scale the (B,C) mean, not the map
            return h.q.to(torch.float32).mean(dim=(1, 2)) * h.scale
        return h.mean(dim=(1, 2))

    return conv_fn, fc_fn, glue_fn, pool_fn


def _make_stage_fns(cfg, kw):
    """Split the compiled layer plan at the early-exit boundaries.

    Returns ``(stage_fns, stage_exits)``: segment ``i < last`` maps
    ``(params, carry) -> (exits, carry)`` with the boundary head's logits
    and the int8 :class:`QAct` carry; the final segment maps
    ``(params, carry) -> logits``.  Chaining the segments is value-identical
    to the monolithic ``fn_exits`` (same layer names, plan entries and
    kernels) and bit-exact at fixed batch geometry."""
    bounds = tuple(sorted(cfg.exit_stages))
    fns, lo = [], 0
    for s in bounds:
        @torch.inference_mode()
        def seg(p, h, *, _lo=lo, _hi=s):
            return cnn_lib.cnn_forward(p, cfg, h, collect_exits=True,
                                       start_stage=_lo, stop_stage=_hi, **kw)
        fns.append(seg)
        lo = s + 1

    @torch.inference_mode()
    def final(p, h, *, _lo=lo):
        return cnn_lib.cnn_forward(p, cfg, h, start_stage=_lo, **kw)
    fns.append(final)
    return tuple(fns), bounds + (None,)


def _layer_segments(plan: LayerPlan, cfg, stage_exits) -> dict:
    """``{layer name: segment}``: the stage segment that runs each plan
    entry (an exit head runs in the segment ending at its stage, the final
    head in the last)."""
    bounds = [s for s in stage_exits if s is not None]
    last = len(cfg.stage_blocks) - 1

    def stage_of(name):
        head = name.split('.')[0]
        if head == 'stem':
            return 0
        if head == 'head':
            return last
        if head.startswith('exit'):
            return int(head[4:])
        return int(head[1:].split('b')[0])

    return {name: next((i for i, b in enumerate(bounds)
                        if stage_of(name) <= b), len(bounds))
            for name in plan.layers}


def _segment_launches(plan: LayerPlan, cfg, stage_exits) -> tuple:
    """``{kernel: launches}`` of each stage segment: the plan's layers
    grouped by :func:`_layer_segments`, counted per kernel
    (:func:`layer_kernel_launches`)."""
    out = [{} for _ in stage_exits]
    for name, seg in _layer_segments(plan, cfg, stage_exits).items():
        for k, n in layer_kernel_launches(plan.layers[name]).items():
            out[seg][k] = out[seg].get(k, 0) + n
    return tuple(out)


def exit_confidence(head_logits):
    """THE early-exit decision quantity: fp32 softmax max-confidence per
    sample.  A sample exits iff ``exit_confidence(head) > threshold``,
    strictly, everywhere."""
    return torch.softmax(head_logits.to(torch.float32), dim=-1).amax(dim=-1)


def early_exit_batch(logits, exits, threshold):
    """Batched early-exit selection: (pred (B,), stage (B,) int32); stage is
    -1 for samples that ran to the final head."""
    pred = torch.argmax(logits, -1)
    stage = torch.full(pred.shape, -1, dtype=torch.int32,
                       device=logits.device)
    taken = torch.zeros(pred.shape, dtype=torch.bool, device=logits.device)
    for s in sorted(exits):
        take = (exit_confidence(exits[s]) > threshold) & ~taken
        pred = torch.where(take, torch.argmax(exits[s], -1), pred)
        stage = torch.where(take, torch.full_like(stage, s), stage)
        taken |= take
    return pred, stage


@dataclass
class ServingModel:
    """A compiled int8 serving endpoint for a compressed model."""
    cfg: Any
    params: Any                # int8 tree: {'w_q', 'scale'(, 'b')} leaves
    fn: Callable               # (params, x) -> logits
    fn_exits: Callable | None = None   # (params, x) -> (logits, exits)
    plan: LayerPlan | None = None
    exit_threshold: float = 0.9
    stage_fns: tuple | None = None     # layer plan split at exit boundaries
    stage_exits: tuple = ()            # exit stage each segment ends at
    segment_launches: tuple = ()       # {kernel: launches} per segment
    device: torch.device = torch.device('cpu')
    backend: str = 'plain'             # 'cuda' kernels | 'plain' versions
    analysis: Any = None               # AnalysisReport from export verify=
    stage_devices: tuple = ()          # torch device pinned per segment
    stage_params: tuple | None = None  # params on stage_devices

    def serve(self, x):
        return self.fn(self.params, x)

    def serve_early_exit(self, x, threshold=None):
        """(pred, stage) per sample; requires exported exit heads.
        ``threshold=None`` uses the model's operating point."""
        if self.fn_exits is None:
            raise ValueError('model was exported without exit heads')
        if x.shape[0] == 0:
            z = torch.zeros((0,), dtype=torch.int32, device=self.device)
            return z, z
        if threshold is None:
            threshold = self.exit_threshold
        logits, exits = self.fn_exits(self.params, x)
        return early_exit_batch(logits, exits, threshold)

    @property
    def n_stages(self) -> int:
        """Number of stage-resumable segments (0 = no exit heads)."""
        return len(self.stage_fns) if self.stage_fns else 0

    def run_stage(self, i: int, carry):
        """Run segment ``i``: ``carry`` is the input batch for ``i == 0``,
        else the carry segment ``i - 1`` returned (an int8 ``QAct``).
        Intermediate segments return ``(exits, carry)``; the last returns
        logits.  On a placed model (:meth:`place_stages`) the segment reads
        the params copy on its device, so it runs where the placement put
        it (the carry must be there too)."""
        if not self.stage_fns:
            raise ValueError('model was exported without exit heads '
                             '(no stage boundaries to resume at)')
        params = (self.stage_params[i] if self.stage_params is not None
                  else self.params)
        return self.stage_fns[i](params, carry)

    def place_stages(self, devices) -> 'ServingModel':
        """Pin segment ``k`` to ``devices[k]`` (one torch device a stage).

        Returns a NEW ServingModel whose ``stage_params[k]`` is the params
        tree on ``devices[k]`` (one copy a *distinct* device, shared by the
        stages on it; on the model's own device the params themselves,
        ``.to`` copying nothing).  The compiled math is unchanged, so
        answers stay bit-exact with the unplaced model.  The int8 ``QAct``
        carry between segments is NOT moved here: moving it across stage
        boundaries is the scheduler's job (serving/placement.py).  A
        ``cuda`` device without an index is read as the current card."""
        if not self.stage_fns:
            raise ValueError('model was exported without exit heads '
                             '(no stages to place)')
        devices = tuple(_indexed(d) for d in devices)
        if len(devices) != self.n_stages:
            raise ValueError(
                f'need one device per stage: got {len(devices)} devices '
                f'for {self.n_stages} stages')
        per_dev = {}
        for d in devices:
            if d not in per_dev:
                per_dev[d] = to_device(self.params, d)
        return replace(self, stage_devices=devices,
                       stage_params=tuple(per_dev[d] for d in devices))

    def serve_stages(self, x):
        """Chain every stage segment: ``(logits, exits)``, value-identical
        to ``fn_exits(params, x)``."""
        exits, h = {}, x
        for i in range(self.n_stages - 1):
            seg_exits, h = self.run_stage(i, h)
            exits.update(seg_exits)
        return self.run_stage(self.n_stages - 1, h), exits

    def summary(self) -> dict | None:
        """The layer plan's deployed-cost summary.  Exports built with
        ``verify=`` carry their structured ``AnalysisReport`` under the
        ``analysis`` key."""
        if self.plan is None:
            return None
        s = self.plan.summary()
        if self.analysis is not None:
            s['analysis'] = self.analysis.to_dict()
        return s


def calibrate_exit_threshold(model: ServingModel, x, quantile=0.5):
    """The confidence threshold at which a ``quantile`` fraction of the
    batch ``x`` exits at its earliest head.  Pure: the caller decides where
    the value lives."""
    if model.fn_exits is None:
        raise ValueError('model was exported without exit heads')
    _, exits = model.fn_exits(model.params, x)
    conf = exit_confidence(exits[min(exits)])
    return float(torch.quantile(conf, 1.0 - quantile)) - 1e-6


def k_major(w):
    """w's values in K-major memory, for the wgmma route of
    ``quant_matmul``: an HWIO conv weight gets the strides of a contiguous
    OHWI tensor, a (K, N) dense weight those of its contiguous transpose.
    Shape and values stay; ``w.reshape(KH*KW*CIN, COUT)`` in
    ``quant_conv`` is then a view with strides (1, K)."""
    if w.dim() == 4:
        return w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    return w.t().contiguous().t()


def _k_major_weights(qparams) -> None:
    """Lay every weight either tier sends to ``quant_matmul`` or
    ``lowrank_conv`` out K-major, in place: the convs and dense heads,
    both halves of a factored pair; the s8 tensor-core operands of both
    kernels are K-major.  The depthwise leaves (``dw``) keep their
    layout: that kernel reads w row-major."""
    def walk(node, key=''):
        if isinstance(node, dict):
            if 'w_q' in node and key != 'dw':
                node['w_q'] = k_major(node['w_q'])
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)
    walk(qparams)


def export_cnn(params, cfg, *, device='cuda', calibrate=None,
               fuse_lowrank=True, select_kernels='model', verify=None,
               tracer=None) -> ServingModel:
    """Compile a (possibly low-rank-factored) CNN to int8 serving on
    ``device``.

    ``calibrate`` (a sample input batch) selects the int8-resident plan:
    static activation scales, requantize epilogues, and cost-selected
    low-rank lowerings (the calibration forward runs ``fake_quant_fused``
    on the 2-D head weights on the card).  A factored conv inside the
    fused envelope is priced fused against chained:
    ``select_kernels='model'`` (the H100 cost model ``lowering_costs``),
    ``'measure'`` (both lowerings raced on ``device``,
    :func:`_measure_lowrank_selection`) or ``'fused'`` (forced);
    ``fuse_lowrank=False`` forces the chained pair.
    ``calibrate=None`` keeps the dynamic-scale path (one abs-max per layer
    per call, fp32 activations between layers; no plan).  Parameters and
    the batch are moved to ``device``; on CUDA every layer runs a kernel
    (``quant_matmul``, ``depthwise_conv``, ``lowrank_conv``).  ``tracer``
    (an ``obs.trace.Tracer``) records an ``export.calibrate`` span and, in
    measure mode, one ``kernel.launch`` span per timed lowering rep.

    ``verify`` runs the analyzer (``repro_torch.analysis``) over the
    export, which runs ``fn``, ``fn_exits`` and the stage segments once on
    the calibration batch on ``device`` (a dynamic-scale export has no
    plan, and the rules that read one are skipped):
    ``'strict'`` raises :class:`~repro_torch.analysis.AnalysisError` on
    any error-severity finding, ``'warn'`` only records them.  Either way
    the structured ``AnalysisReport`` lands on ``model.analysis`` and in
    ``model.summary()['analysis']``.  ``None`` (default) skips analysis —
    exports on hot paths stay cheap."""
    from repro_torch.obs.trace import as_tracer
    tracer = as_tracer(tracer)
    if select_kernels not in SELECT_KERNELS:
        raise ValueError(f'select_kernels must be one of {SELECT_KERNELS}, '
                         f'got {select_kernels!r}')
    if verify not in (None, 'strict', 'warn'):
        raise ValueError(f"verify must be None, 'strict' or 'warn', "
                         f'got {verify!r}')
    device = resolve_device(device)
    params = to_device(params, device)
    w_bits, a_bits = _serving_bits(cfg)
    plan = None
    with full_fp32(), torch.no_grad():
        qparams = quantize_params_for_serving(params, bits=w_bits)
        if calibrate is not None:
            calibrate = calibrate.to(device)
            with tracer.span('export.calibrate', track='export',
                             config=cfg.name, select_kernels=select_kernels,
                             batch=int(calibrate.shape[0])):
                plan = _compile_layer_plan(params, cfg, calibrate,
                                           2.0 ** (a_bits - 1) - 1.0,
                                           fuse_lowrank=fuse_lowrank,
                                           select_kernels=select_kernels)
    _k_major_weights(qparams)
    if plan is not None and select_kernels == 'measure' and fuse_lowrank:
        with torch.inference_mode():
            _measure_lowrank_selection(plan, qparams, device, tracer=tracer)
    if plan is not None:
        conv_fn, fc_fn, glue_fn, pool_fn = _resident_layers(plan)
        kw = dict(conv_fn=conv_fn, fc_fn=fc_fn, glue_fn=glue_fn,
                  pool_fn=pool_fn)
    else:
        conv_fn, fc_fn = _serving_layers(a_bits)
        kw = dict(conv_fn=conv_fn, fc_fn=fc_fn)

    @torch.inference_mode()
    def fn(p, x):
        return cnn_lib.cnn_forward(p, cfg, x, **kw)

    @torch.inference_mode()
    def fn_exits(p, x):
        return cnn_lib.cnn_forward(p, cfg, x, collect_exits=True, **kw)

    stage_fns, stage_exits, seg_launches = None, (), ()
    if cfg.exit_stages:
        stage_fns, stage_exits = _make_stage_fns(cfg, kw)
        if plan is not None:
            seg_launches = _segment_launches(plan, cfg, stage_exits)
    model = ServingModel(cfg=cfg, params=qparams, fn=fn,
                         fn_exits=fn_exits if cfg.exit_stages else None,
                         plan=plan, stage_fns=stage_fns,
                         stage_exits=stage_exits,
                         segment_launches=seg_launches, device=device,
                         backend='cuda' if device.type == 'cuda' else 'plain')
    if verify is not None:
        from repro_torch.analysis import check   # lazy: analysis reads core
        model.analysis = check(model, x=calibrate,
                               strict=(verify == 'strict'))
    return model


# ------------------------------------------------------------------ LM export


def export_lm(params, cfg) -> ServingModel:
    """Int8 export for the LM family, on the device the params are on:
    every matmul weight (2-D, and the scan-stacked ``(G, d, f)`` ones,
    both halves of a factored ``{'u', 'v'}`` pair, the exit heads'
    adapters, MoE routers and expert tensors) becomes ``{'w_q', 'scale'}``
    through ``quantize_params_for_serving``, which ``layers.dense`` and
    ``moe.moe_block`` consume (dequantized before their products, as in
    the reference); MLA's ``wk_b``/``wv_b`` stay float.  Embedding
    tables and norms stay as they are.  ``fn(params, tokens)`` is the
    full-sequence forward; serving decodes with ``launch/serve.py``; the
    exit heads serve through ``family.exit_logits``.  The reference jits
    ``fn``, so its activation fake quants take the jitted scale
    (``quantization.jitted_scales``); the weight export above divides, as
    the reference's eager export does."""
    from repro_torch.models import transformer as tfm
    w_bits, _ = _serving_bits(cfg)
    with torch.no_grad():
        qparams = quantize_params_for_serving(params, bits=w_bits)

    @torch.inference_mode()
    def fn(p, tokens):
        with jitted_scales():
            return tfm.forward(p, cfg, tokens)

    device = params['embed']['table'].device
    return ServingModel(cfg=cfg, params=qparams, fn=fn, device=device,
                        backend='cuda' if device.type == 'cuda' else 'plain')


# ----------------------------------------------------- serving backends

# {family class: (state, device, calibrate) -> ServingModel}.  Third-party
# model families register here (mirroring the pass registry in
# core/registry.py) instead of core growing isinstance branches; lookup
# walks the MRO so subclassed families inherit their base family's backend.
_SERVING_BACKENDS: dict[type, Callable] = {}


def register_serving_backend(family_cls: type, backend: Callable) -> None:
    _SERVING_BACKENDS[family_cls] = backend


def serving_backend_for(family) -> Callable:
    for cls in type(family).__mro__:
        if cls in _SERVING_BACKENDS:
            return _SERVING_BACKENDS[cls]
    raise KeyError(
        f'no serving backend registered for family {type(family).__name__} '
        f'(registered: {sorted(c.__name__ for c in _SERVING_BACKENDS)}); '
        f'call export.register_serving_backend(FamilyCls, backend)')


def export_chain(state, *, device='cuda', calibrate=None) -> ServingModel:
    """Export a finished ChainState for serving via the family's registered
    backend, on ``device`` (the port's form of the reference's
    ``use_pallas``, as in :func:`export_cnn`).  ``calibrate`` (sample
    inputs) requests the int8-resident plan; the chain's E-pass operating
    point (``state.exit_threshold``) is threaded into the served model.

    Backends registered with the two-argument ``(state, device)`` form
    keep working: ``calibrate`` is only forwarded (as a keyword) to
    backends that declare it, and raises for the others."""
    import inspect
    backend = serving_backend_for(state.family)
    sig = inspect.signature(backend).parameters
    takes_calibrate = 'calibrate' in sig or any(
        p.kind is p.VAR_KEYWORD for p in sig.values())
    if takes_calibrate:
        model = backend(state, device, calibrate=calibrate)
    elif calibrate is not None:
        raise TypeError(
            f'serving backend {backend!r} for {type(state.family).__name__} '
            f'does not accept calibrate= (int8-resident export); register '
            f'a backend with a (state, device, calibrate=None) signature')
    else:
        model = backend(state, device)
    if getattr(state, 'exit_threshold', None) is not None:
        model.exit_threshold = state.exit_threshold
    return model


def _register_builtin_backends():
    from repro_torch.core.family import CNNFamily, LMFamily
    register_serving_backend(
        CNNFamily, lambda state, device, calibrate=None: export_cnn(
            state.params, state.cfg, device=device, calibrate=calibrate))
    # the LM backend has no resident plan yet: it keeps the two-argument
    # form so export_chain's calibrate guard raises instead of silently
    # ignoring a calibration batch
    register_serving_backend(
        LMFamily, lambda state, device: export_lm(
            to_device(state.params, resolve_device(device)), state.cfg))


_register_builtin_backends()
