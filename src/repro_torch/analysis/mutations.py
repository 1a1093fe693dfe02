"""Deliberately-broken targets that each analyzer rule must catch (the
reference's ``analysis/mutations.py`` on PyTorch).

Every rule ships with a mutation factory proving it is *live*: the factory
builds a target violating exactly that rule's contract and returns the
``analysis.check(...)`` kwargs to run it (restricted to the one rule, so
the red/green verdict is attributable).  tests/test_torch_analysis.py
asserts red-on-mutant per rule, and ``python -m repro_torch.analysis.gate``
(the scripts/ci_torch.sh verify stage) refuses to pass unless every mutant
FAILS — a rule that silently stops firing breaks CI, not production.

Every mutant is built and checked on the CPU, where the kernel wrappers
run their plain versions: none reaches a launcher.  Factories are
functions (not precomputed fixtures) because most perform a real export;
callers invoke only what they need.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch


def _resnet_export(*, factorize=False, exits=False):
    """A W8A8 resnet8 export on the CPU from seeded weights: ``(model,
    params, cfg, x)`` with x two 16 x 16 images."""
    from repro_torch.configs.cnn import RESNET8_CIFAR
    from repro_torch.core.export import export_cnn
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages
    cfg = RESNET8_CIFAR.replace(w_bits=8, a_bits=8)
    fam = CNNFamily(SyntheticImages(), device='cpu')
    params = fam.init(torch.Generator().manual_seed(0), cfg)
    if factorize:
        params, cfg, _ = fam.factorize(params, cfg, energy=0.6, min_rank=2)
    if exits:
        params, cfg = fam.add_exits(torch.Generator().manual_seed(2),
                                    params, cfg,
                                    fam.default_exit_points(cfg))
        cfg = cfg.replace(w_bits=8, a_bits=8)
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    model = export_cnn(params, cfg, device='cpu', calibrate=x)
    return model, params, cfg, x


def mutant_int8_residency():
    """A 'resident' export whose run still computes dynamic abs-max: the
    dynamic-scale serving fn grafted under a calibrated plan.  The
    int8-residency rule must flag the abs-max ops (and the fp32 kernel
    outputs between layers)."""
    resident, params, cfg, x = _resnet_export()
    from repro_torch.core.export import export_cnn
    mutant = export_cnn(params, cfg, device='cpu')   # dynamic scales
    mutant.plan = resident.plan            # claims residency it doesn't have
    return {'model': mutant, 'x': x, 'rules': ('int8-residency',),
            'target': 'mutant:int8-residency'}


def mutant_smem_fit():
    """A serving fn that calls ``lowrank_conv`` under a launch plan made
    too large: the real plan with an 8-stage ring of 128-wide rank tiles,
    about 299 KiB of shared memory a block (budget 227 KiB).  ``lr_plan``
    asserts its own fit, so the stand-in swaps the plan function for the
    call; on CPU tensors the wrapper runs its plain version and records
    the plan, never reaching a launcher."""
    from repro_torch.kernels import lowrank_conv as lr
    g = torch.Generator().manual_seed(0)
    m, k1, r, n = 256, 64, 100, 64

    def i8(*shape):
        return torch.randint(-8, 8, shape, generator=g, dtype=torch.int8)
    patches, u, v = i8(m, k1), i8(k1, r), i8(r, n)
    real = lr.lr_plan

    def too_big(M, K1, R, N):
        bm, rp, vn, _, c, _ = real(M, K1, R, N)
        return bm, rp, vn, 8, c, lr.lr_smem_bytes(rp, vn, 8, c)

    def fn(p, x):
        del p
        lr.lr_plan = too_big
        try:
            return lr.lowrank_conv(
                x, u, v, torch.ones(r), torch.ones(n), torch.zeros(r),
                torch.zeros(n), sx=0.1, h_scale=0.1, out_scale=0.1)
        finally:
            lr.lr_plan = real

    model = SimpleNamespace(fn=fn, fn_exits=None, params=None, plan=None,
                            backend='plain', cfg=None, stage_fns=None)
    return {'model': model, 'x': patches, 'rules': ('smem-fit',),
            'target': 'mutant:smem-fit'}


def mutant_launch_budget():
    """A factored resident export whose plan claims two launches for a
    layer the run serves fused (one ``lowrank_conv`` call) — the classic
    drift between the launch accounting and the served graph."""
    model, _, _, x = _resnet_export(factorize=True)
    fused = [e for e in model.plan.layers.values()
             if e.get('fused') and e['kind'] == 'conv']
    assert fused, 'mutation needs at least one fused low-rank layer'
    fused[0]['launches'] = 2               # the run still calls once
    return {'model': model, 'x': x, 'rules': ('launch-budget',),
            'target': 'mutant:launch-budget'}


def mutant_stage_carry():
    """A stage-split export whose first segment dequantizes its carry to
    fp32 before handing it across the stage boundary — 4x the inter-stage
    bytes and a broken scheduler contract."""
    model, _, _, x = _resnet_export(exits=True)
    orig = model.stage_fns[0]

    def leaky(p, h):
        exits, carry = orig(p, h)
        return exits, carry.q.to(torch.float32) * carry.scale

    model.stage_fns = (leaky,) + model.stage_fns[1:]
    return {'model': model, 'x': x, 'rules': ('stage-carry',),
            'target': 'mutant:stage-carry'}


def mutant_placement_consistency():
    """A placed stage-split export whose placement lost a stage: the last
    segment has no assigned device (and no committed params copy) — the
    exact inconsistency a buggy re-solve after a device kill would ship.
    Works on a single device: the clean placement pins every stage to the
    model's device, the mutant then truncates one assignment."""
    model, _, _, x = _resnet_export(exits=True)
    placed = model.place_stages((model.device,) * model.n_stages)
    broken = dataclasses.replace(
        placed, stage_devices=placed.stage_devices[:-1] + (None,),
        stage_params=placed.stage_params[:-1] + (None,))
    return {'model': broken, 'x': x, 'rules': ('placement-consistency',),
            'target': 'mutant:placement-consistency'}


def mutant_order_dag():
    """Quantization before pruning: 'QP' reverses the theoretical edge
    P→Q (neuron granularity precedes sub-neuron)."""
    return {'sequence': 'QP', 'rules': ('order-dag',),
            'target': 'mutant:order-dag'}


def mutant_trace_invariants():
    """A runtime trace with a torn span (t1 < t0) and two stage.exec
    spans claiming the same replica concurrently — the two ways a buggy
    scheduler most plausibly corrupts its own evidence.  The
    trace-invariants rule must flag both."""
    from repro_torch.obs.trace import Span
    spans = [
        Span('stage.exec', 0.000, 0.004, 'replica0',
             args={'stage': 0, 'live': 8, 'slots': 8, 'rids': [0]}),
        Span('stage.exec', 0.002, 0.006, 'replica0',          # concurrent
             args={'stage': 1, 'live': 4, 'slots': 8, 'rids': [1]}),
        Span('stage.exec', 0.010, 0.008, 'replica1',          # torn
             args={'stage': 0, 'live': 8, 'slots': 8, 'rids': [2]}),
    ]
    return {'trace': spans, 'rules': ('trace-invariants',),
            'target': 'mutant:trace-invariants'}


def mutant_op_traffic():
    """A serving fn that silently runs the network twice (averaged over
    the input and its mirror) under an unchanged plan: about 2x the
    predicted bytes, well past the 20% budget."""
    model, _, _, x = _resnet_export()
    orig = model.fn

    def doubled(p, v):
        return 0.5 * (orig(p, v) + orig(p, torch.flip(v, dims=(1,))))

    model.fn = doubled
    return {'model': model, 'x': x, 'rules': ('op-traffic',),
            'target': 'mutant:op-traffic'}


#: rule key -> factory returning analysis.check(**kwargs) for a target
#: that MUST produce an error finding from exactly that rule.
MUTANTS = {
    'int8-residency': mutant_int8_residency,
    'smem-fit': mutant_smem_fit,
    'launch-budget': mutant_launch_budget,
    'stage-carry': mutant_stage_carry,
    'order-dag': mutant_order_dag,
    'placement-consistency': mutant_placement_consistency,
    'op-traffic': mutant_op_traffic,
    'trace-invariants': mutant_trace_invariants,
}
