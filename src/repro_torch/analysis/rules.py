"""The rule-registry analyzer: serving contracts checked at export (the
reference's ``analysis/rules.py`` on PyTorch).

Mirrors the core/registry.py idiom — rules are registrable data
(:class:`AnalysisRule`: key + severity + requirements + check fn), a
process-global registry (:func:`register_rule` / :func:`unregister_rule` /
:func:`get_rule` / :func:`registered_rules`), and one entry point
(:func:`check`) that runs every applicable rule over a target and returns
a structured :class:`~repro_torch.analysis.report.AnalysisReport`.

Where the reference traces jaxprs and executes nothing, the port's
:class:`AnalysisContext` runs each serving function once on the example
input, on the model's device, under ``analysis.walker``'s recorders (the
kernel calls with their launch plans, the torch ops outside the wrappers)
and caches what they record; every rule reads that cache.

Builtin rules (see README.md in this package):

=====================  ========  ==========================================
int8-residency         error     fp32 only at logits / declared fallbacks;
                                 zero activation abs-max ops and zero
                                 weight-scale recompute in a calibrated
                                 resident run; every kernel call int8 in
smem-fit               error     every recorded launch plan's shared memory
                                 fits ``tiling.SMEM_BUDGET`` (and the
                                 card's opt-in limit on a card)
launch-budget          error     recorded kernel calls == the layer plan's
                                 launch accounting, per segment too, incl.
                                 fused/chained selections; on a card the
                                 wrappers' launch counters agree, no plain
                                 call
stage-carry            error     stage boundaries exchange int8 QAct with
                                 static float scales; no host sync inside a
                                 segment
order-dag              error     a Pipeline sequence respects every
                                 theoretical order edge
                                 (``planner.theoretical_dag``)
op-traffic             error     the bytes one ``fn`` call writes within
                                 20% of the per-layer prediction
                                 (``traffic.py``)
placement-consistency  error     a placed export: one device a stage, its
                                 params there, int8 carries across devices
trace-invariants       error     a recorded runtime trace satisfies the
                                 span invariants (``obs.check_trace``)
=====================  ========  ==========================================

A rule whose requirements the target cannot satisfy (e.g. order-dag with
no sequence, placement-consistency on an export that was never placed) is
*skipped* and recorded as such in the report — skipping is visible, never
silent.
"""
from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.analysis.report import SEVERITIES, AnalysisReport, Finding
from repro_torch.analysis.walker import (call_smem_bytes, op_count,
                                         record_run, tensors_in)

#: What a rule may declare in ``requires`` — :meth:`AnalysisContext.has`
#: answers each against the target.  ``'kernels'``: the export runs the
#: CUDA kernels (``model.backend == 'cuda'``), the reference's ``'pallas'``.
KNOWN_REQUIRES = ('model', 'plan', 'kernels', 'stages', 'sequence', 'input',
                  'trace', 'placement')

#: op-traffic: measured bytes may exceed the prediction by this fraction
#: before the rule errors (the reference's ``HLO_TRAFFIC_TOL``).
OP_TRAFFIC_TOL = 0.20

_KEY_RE = re.compile(r'^[a-z0-9]+(-[a-z0-9]+)*$')

# ops that compute an activation abs-max at serve time (a dynamic scale)
_ABSMAX_OPS = ('aten.amax', 'aten.max', 'aten.aminmax')
# fp32 convolutions outside the kernel wrappers
_CONV_OPS = ('aten.convolution', 'aten._convolution', 'aten.conv2d')


@dataclass(frozen=True)
class AnalysisRule:
    """A registrable serving contract: metadata + the check itself."""
    key: str             # kebab-case, e.g. 'int8-residency'
    severity: str        # default severity of this rule's findings
    requires: tuple      # subset of KNOWN_REQUIRES the target must satisfy
    doc: str             # one-line contract statement (shown in README/CLI)
    fn: Callable         # (ctx: AnalysisContext, rule) -> iterable[Finding]

    def finding(self, message: str, *, where: str | None = None,
                severity: str | None = None) -> Finding:
        """Build a finding attributed to this rule (default severity)."""
        return Finding(self.key, severity or self.severity, message, where)


# ----------------------------------------------------------------- registry


_RULES: dict[str, AnalysisRule] = {}


def register_rule(rule: AnalysisRule, *, replace: bool = False
                  ) -> AnalysisRule:
    """Register a rule under its key.  Raises on collisions unless
    ``replace=True`` (a third-party rule must not shadow silently)."""
    if not _KEY_RE.match(rule.key or ''):
        raise ValueError(f'rule key must be kebab-case '
                         f'([a-z0-9-]), got {rule.key!r}')
    if rule.severity not in SEVERITIES:
        raise ValueError(f'rule {rule.key!r}: unknown severity '
                         f'{rule.severity!r} (one of {SEVERITIES})')
    unknown = sorted(set(rule.requires) - set(KNOWN_REQUIRES))
    if unknown:
        raise ValueError(f'rule {rule.key!r}: unknown requirements '
                         f'{unknown} (known: {KNOWN_REQUIRES})')
    if not callable(rule.fn):
        raise ValueError(f'rule {rule.key!r}: fn must be callable')
    if rule.key in _RULES and not replace:
        raise ValueError(f'rule key {rule.key!r} already registered; '
                         f'use replace=True')
    _RULES[rule.key] = rule
    return rule


def unregister_rule(key: str) -> AnalysisRule:
    """Remove and return a registered rule (tests round-trip through it)."""
    try:
        return _RULES.pop(key)
    except KeyError:
        raise KeyError(f'rule {key!r} is not registered '
                       f'(have {registered_rules()})') from None


def get_rule(key: str) -> AnalysisRule:
    try:
        return _RULES[key]
    except KeyError:
        raise KeyError(f'unknown rule {key!r} '
                       f'(registered: {registered_rules()})') from None


def registered_rules() -> tuple:
    """All registered rule keys, sorted alphabetically."""
    return tuple(sorted(_RULES))


# ------------------------------------------------------------------ context


class AnalysisContext:
    """Lazy, cached recorded runs of the analysis target.

    Each serving function (``fn``, ``fn_exits``, the stage segments
    chained) runs at most once per :func:`check`, on the model's device,
    no matter how many rules read it; the weight-scale recompute delta and
    the wrappers' counters are read around the first run."""

    def __init__(self, model=None, sequence=None, x=None, trace=None,
                 completions=None):
        self.model = model
        self.sequence = sequence
        self.trace = trace                # Tracer, span list, or trace path
        self.completions = completions    # {rid: Completion} (optional)
        self._x = x
        self._runs: dict = {}
        self._counts: dict = {}
        self._stages: list | None = None
        self._scale_delta: int | None = None

    # -- capability probes (rule `requires`) --

    def has(self, req: str) -> bool:
        if req == 'model':
            return self.model is not None
        if req == 'plan':
            return getattr(self.model, 'plan', None) is not None
        if req == 'kernels':
            return getattr(self.model, 'backend', None) == 'cuda'
        if req == 'stages':
            return bool(getattr(self.model, 'stage_fns', None))
        if req == 'sequence':
            return self.sequence is not None
        if req == 'input':
            return self.example_input() is not None
        if req == 'trace':
            return self.trace is not None
        if req == 'placement':
            return bool(getattr(self.model, 'stage_devices', None))
        raise ValueError(f'unknown requirement {req!r} '
                         f'(known: {KNOWN_REQUIRES})')

    def missing(self, rule: AnalysisRule) -> list:
        return [r for r in rule.requires if not self.has(r)]

    # -- target views --

    def example_input(self):
        """The serving input on the model's device: caller-provided, else
        zeros at the resident plan's first layer's input shape (its
        recorded calibration geometry)."""
        plan = getattr(self.model, 'plan', None)
        if self._x is None and plan is not None:
            first = next(iter(plan.layers.values()))
            self._x = torch.zeros(first['in_shape'], dtype=torch.float32)
        dev = getattr(self.model, 'device', None)
        if self._x is not None and dev is not None:
            self._x = self._x.to(dev)
        return self._x

    def sequence_str(self) -> str:
        """The pass-key string of the target sequence (accepts a raw
        string or anything with a ``.sequence`` — e.g. chain.Pipeline)."""
        return getattr(self.sequence, 'sequence', self.sequence)

    def run(self, which: str = 'fn'):
        """The recorded run (``walker.Run``) of ``fn`` or ``fn_exits``."""
        if which not in self._runs:
            from repro_torch.core import quantization
            from repro_torch.kernels import counts
            m = self.model
            fn = m.fn if which == 'fn' else m.fn_exits
            before, c0 = quantization.WEIGHT_SCALE_COMPUTATIONS[0], counts()
            self._runs[which] = record_run(fn, m.params,
                                           self.example_input())
            c1 = counts()
            self._counts[which] = {
                k: {n: c1[k][n] - c0[k][n] for n in c1[k]} for k in c1}
            delta = quantization.WEIGHT_SCALE_COMPUTATIONS[0] - before
            if self._scale_delta is None:
                self._scale_delta = delta
        return self._runs[which]

    def counter_delta(self, which: str = 'fn') -> dict:
        """``{kernel: {'launches': n, 'plain_calls': m}}`` the run of
        ``which`` added to the wrappers' counters."""
        self.run(which)
        return self._counts[which]

    def main_run(self):
        """(run, label) of the widest serving function — ``fn_exits`` when
        exported, else ``fn`` — so checks cover the exit heads too."""
        if getattr(self.model, 'fn_exits', None) is not None:
            return self.run('fn_exits'), 'fn_exits'
        return self.run('fn'), 'fn'

    def stage_runs(self) -> list:
        """The recorded run of each stage segment, chained from the
        example input (segment ``i`` takes segment ``i - 1``'s carry)."""
        if self._stages is None:
            m, carry, runs = self.model, self.example_input(), []
            for i, fn in enumerate(m.stage_fns):
                runs.append(record_run(fn, m.params, carry))
                if i < len(m.stage_fns) - 1:
                    carry = runs[-1].out[1]
            self._stages = runs
        return self._stages

    def n_heads(self) -> int:
        """fp32 logit heads the main run legitimately emits."""
        if getattr(self.model, 'fn_exits', None) is None:
            return 1
        cfg = getattr(self.model, 'cfg', None)
        return 1 + len(tuple(getattr(cfg, 'exit_stages', ()) or ()))

    def scale_delta(self) -> int:
        """Weight-scale recomputations observed while running the serving
        fn (quantization.WEIGHT_SCALE_COMPUTATIONS delta; must be 0)."""
        if self._scale_delta is None:
            self.main_run()
        return self._scale_delta


# -------------------------------------------------------------- entry point


def check(model=None, *, sequence=None, x=None, rules=None,
          strict: bool = False, target: str = '', trace=None,
          completions=None) -> AnalysisReport:
    """Run every applicable registered rule over the target.

    ``model`` — a ServingModel (or anything shaped like one);
    ``sequence`` — a pass-key string or Pipeline for the order-dag rule;
    ``x`` — example input override (derived from the plan when omitted);
    ``rules`` — restrict to these keys (default: all registered);
    ``strict`` — raise :class:`AnalysisError` on any error finding;
    ``trace`` — runtime evidence for the trace-invariants rule: a
    ``repro_torch.obs.Tracer``, a span list, or a Chrome-trace file path,
    with ``completions`` (``{rid: Completion}``) enabling the
    latency-extent checks.

    Rules whose requirements the target cannot satisfy are recorded under
    ``report.skipped`` with the unmet requirement — not silently dropped.
    """
    ctx = AnalysisContext(model=model, sequence=sequence, x=x, trace=trace,
                          completions=completions)
    keys = tuple(rules) if rules is not None else registered_rules()
    findings, checked, skipped = [], [], []
    for key in keys:
        rule = get_rule(key)
        missing = ctx.missing(rule)
        if missing:
            skipped.append((key, f'target lacks {"/".join(missing)}'))
            continue
        findings.extend(rule.fn(ctx, rule))
        checked.append(key)
    if not target:
        cfg = getattr(model, 'cfg', None)
        target = getattr(cfg, 'name', None) or \
            (f'sequence {ctx.sequence_str()!r}' if sequence is not None
             else 'trace' if trace is not None else 'model')
    report = AnalysisReport(findings=tuple(findings), checked=tuple(checked),
                            skipped=tuple(skipped), target=target)
    if strict:
        report.raise_if_errors()
    return report


# ------------------------------------------------------------ builtin rules


def _main_layers(model) -> dict:
    return {n: e for n, e in model.plan.layers.items()
            if not n.startswith('exit')}


def _planned_calls(layers) -> Counter:
    """``{kernel: calls}`` the plan entries make a batch."""
    from repro_torch.core.export import layer_kernel_launches
    want = Counter()
    for e in layers:
        want.update(layer_kernel_launches(e))
    return want


def _rule_int8_residency(ctx: AnalysisContext, rule: AnalysisRule):
    """fp32 appears only at logit heads / declared fallbacks; no dynamic
    activation abs-max and no weight-scale recompute survive in a
    calibrated resident run; every kernel call consumes int8."""
    out = []
    run, label = ctx.main_run()
    n_rm = op_count(run.ops, *_ABSMAX_OPS)
    if n_rm:
        out.append(rule.finding(
            f'{n_rm} abs-max op(s) ({"/".join(_ABSMAX_OPS)}) in the '
            f'calibrated resident run — an activation abs-max runs at '
            f'serve time (activation scales must be static calibration '
            f'constants)', where=label))
    if ctx.scale_delta():
        out.append(rule.finding(
            f'{ctx.scale_delta()} weight-scale recomputation(s) while '
            f'running the serving fn — weight scales must be snapshotted '
            f'at export, not derived per call', where=label))
    model = ctx.model
    from repro_torch.kernels.depthwise_conv import fits_depthwise
    for name, e in model.plan.layers.items():
        if e.get('fallback') and e.get('w_shape') is not None \
                and fits_depthwise(e['w_shape']):
            out.append(rule.finding(
                f'layer declares an fp32 grouped-conv fallback but its '
                f'weight {e["w_shape"]} fits the int8 depthwise kernel — '
                f'resident routing regressed (fallback is reserved for '
                f'per-group depth > 1)', where=name))
    if not run.calls:
        out.append(rule.finding(
            'the resident run made zero kernel calls — the resident path '
            'is not routing through the kernel wrappers', where=label))
        return out
    for c in run.calls:
        dt = c.operands[0][2]
        if dt != torch.int8:
            out.append(rule.finding(
                f'kernel {c.kernel} consumes {dt} activations (int8 '
                f'expected at every kernel boundary)', where=c.kernel))
    out_dtypes = [d for c in run.calls for _, d in c.outputs]
    bad = sorted({str(d) for d in out_dtypes
                  if d not in (torch.int8, torch.float32)})
    if bad:
        out.append(rule.finding(
            f'kernel outputs of dtype {bad} — only int8 boundaries and '
            f'fp32 logits are allowed', where=label))
    n_fp32 = sum(1 for d in out_dtypes if d == torch.float32)
    n_heads = ctx.n_heads()
    if n_fp32 > n_heads:
        out.append(rule.finding(
            f'{n_fp32} fp32 kernel outputs but only {n_heads} logit '
            f'head(s) — an inter-layer boundary leaks fp32 into device '
            f'memory', where=label))
    allowed_convs = sum(1 for e in model.plan.layers.values()
                        if e.get('fallback'))
    n_fp32_convs = sum(1 for o in run.ops if o.name in _CONV_OPS
                       and torch.float32 in o.dtypes)
    if n_fp32_convs > allowed_convs:
        out.append(rule.finding(
            f'{n_fp32_convs} fp32 convolution op(s) vs {allowed_convs} '
            f'declared fallback layer(s) — an undeclared conv dodged the '
            f'int8 kernels', where=label))
    return out


def _rule_smem_fit(ctx: AnalysisContext, rule: AnalysisRule):
    """Every recorded launch plan's shared memory fits the Hopper budget
    (and, on a card, the card's opt-in limit a block) — a launch the C
    launcher would refuse caught at export, not at first launch."""
    from repro_torch.kernels.tiling import SMEM_BUDGET
    out = []
    run, label = ctx.main_run()
    limit = None
    if ctx.has('kernels'):
        limit = torch.cuda.get_device_properties(
            ctx.model.device).shared_memory_per_block_optin
    sized = [(c, call_smem_bytes(c)) for c in run.calls
             if call_smem_bytes(c) is not None]
    for c, b in sized:
        if b > SMEM_BUDGET:
            out.append(rule.finding(
                f'kernel {c.kernel} ({c.route}) plans {b / 1024:.1f} KiB of '
                f'shared memory a block, budget {SMEM_BUDGET / 1024:.0f} '
                f'KiB (tiling.SMEM_BUDGET) — the launcher would refuse '
                f'this plan {c.plan}', where=c.kernel))
        if limit is not None and b > limit:
            out.append(rule.finding(
                f'kernel {c.kernel} ({c.route}) plans {b} bytes of shared '
                f'memory a block, above the card\'s opt-in limit of '
                f'{limit}', where=c.kernel))
    top = max((b for _, b in sized), default=0)
    out.append(rule.finding(
        f'{len(sized)} planned launch(es) checked, the largest '
        f'{top} bytes a block; {len(run.calls) - len(sized)} on routes '
        f'whose shared memory is static (sized by the compiler)',
        where=label, severity='info'))
    return out


def _rule_launch_budget(ctx: AnalysisContext, rule: AnalysisRule):
    """Recorded kernel calls match the layer plan's launch accounting, per
    serving function and per segment, and each factored layer's recorded
    launches agree with its fused/chained selection; on a card, every
    recorded call launched its kernel (the wrappers' counters agree, no
    plain version ran)."""
    out = []
    model = ctx.model
    s = model.plan.summary()
    for name, e in model.plan.layers.items():
        if not (e.get('factored') and e['kind'] == 'conv'):
            continue
        want = 1 if e.get('fused') else 2
        if e.get('launches') != want:
            out.append(rule.finding(
                f'plan records {e.get("launches")} launch(es) for a '
                f'{"fused" if e.get("fused") else "chained"} factored '
                f'layer (expected {want})', where=name))
        sel = e.get('selection') or {}
        choice = sel.get('choice')
        if choice and (choice == 'fused') != bool(e.get('fused')):
            out.append(rule.finding(
                f'plan serves the layer '
                f'{"fused" if e.get("fused") else "chained"} but its '
                f'recorded selection chose {choice!r} — the shipped '
                f'lowering contradicts the cost decision', where=name))
        if 'fused_us' in sel and 'chained_us' in sel:
            want = ('fused' if sel['fused_us'] <= sel['chained_us']
                    else 'chained')
            if choice != want:
                out.append(rule.finding(
                    f'selection chose {choice!r} but its own costs say '
                    f'{want!r} (fused {sel["fused_us"]:.1f}us vs chained '
                    f'{sel["chained_us"]:.1f}us) — the cost model and the '
                    f'decision disagree', where=name))

    def compare(got: Counter, want: Counter, total: int, where: str, what):
        if sum(got.values()) != total or +got != +want:
            out.append(rule.finding(
                f'{sum(got.values())} kernel call(s) {dict(got)} recorded '
                f'in {where} vs {total} planned {dict(+want)} ({what})',
                where=where))

    main = _main_layers(model)
    compare(Counter(c.kernel for c in ctx.run('fn').calls),
            _planned_calls(main.values()), s['kernel_launches'], 'fn',
            'kernel_launches')
    runs = ['fn']
    if getattr(model, 'fn_exits', None) is not None:
        runs.append('fn_exits')
        compare(Counter(c.kernel for c in ctx.run('fn_exits').calls),
                _planned_calls(model.plan.layers.values()),
                s['kernel_launches'] + s['exit_head_launches'], 'fn_exits',
                'main + exit heads')
    seg_plan = getattr(model, 'segment_launches', ()) or ()
    if getattr(model, 'stage_fns', None) and seg_plan:
        for i, run in enumerate(ctx.stage_runs()):
            want = Counter(seg_plan[i])
            compare(Counter(c.kernel for c in run.calls), want,
                    sum(want.values()), f'stage{i}', 'segment_launches')
    for which in runs:
        calls = ctx.run(which).calls
        rec = Counter(c.kernel for c in calls)
        if not ctx.has('kernels'):
            out.append(rule.finding(
                f'{sum(rec.values())} kernel calls recorded {dict(rec)}, '
                f'on the plain versions (CPU tensors)', where=which,
                severity='info'))
            continue
        delta = ctx.counter_delta(which)
        launched = Counter({k: v['launches'] for k, v in delta.items()})
        plain = sum(v['plain_calls'] for v in delta.values())
        n_plain = sum(c.plain for c in calls)
        out.append(rule.finding(
            f'{sum(rec.values())} kernel calls recorded {dict(rec)}; the '
            f'wrappers launched {dict(+launched)}, plain-version calls '
            f'{plain}', where=which, severity='info'))
        if +launched != rec or plain or n_plain:
            out.append(rule.finding(
                f'on the card the wrappers launched {dict(+launched)} for '
                f'{dict(rec)} recorded kernel calls, with {plain} '
                f'plain-version calls and {n_plain} recorded plain — a '
                f'quiet fallback off the kernels', where=which))
    return out


def _rule_stage_carry(ctx: AnalysisContext, rule: AnalysisRule):
    """Every stage boundary exchanges an int8 QAct with a static float
    scale, and no segment syncs with the host — the continuous-batching
    scheduler's carry contract."""
    from repro_torch.core.export import QAct
    out = []
    runs = ctx.stage_runs()
    for i, run in enumerate(runs):
        hosts = sorted({o.name for o in run.ops if o.transfer == 'd2h'})
        if hosts:
            out.append(rule.finding(
                f'segment {i} syncs with the host through {hosts} — stage '
                f'carries must stay on the device', where=f'stage{i}'))
        if i == len(runs) - 1:
            break
        _, carry = run.out
        if not isinstance(carry, QAct):
            dts = sorted({str(t.dtype) for t in tensors_in(carry)})
            out.append(rule.finding(
                f'segment {i} carries {type(carry).__name__} of dtype '
                f'{dts} across the stage boundary — must be an int8 QAct '
                f'(fp32 carries quadruple inter-stage device traffic and '
                f'break the scheduler contract)', where=f'stage{i}'))
        else:
            if carry.q.dtype != torch.int8:
                out.append(rule.finding(
                    f'segment {i} QAct carry holds {carry.q.dtype} codes '
                    f'(int8 expected)', where=f'stage{i}'))
            if not isinstance(carry.scale, float):
                out.append(rule.finding(
                    f'segment {i} QAct scale is {type(carry.scale).__name__}'
                    f' — scales must be static Python floats baked at '
                    f'calibration, not device values', where=f'stage{i}'))
    return out


def _rule_order_dag(ctx: AnalysisContext, rule: AnalysisRule):
    """A pass sequence respects every edge of the theoretical order DAG
    (static before dynamic, large before small granularity) — the paper's
    contribution, linted before any training happens."""
    from repro_torch.core import planner, registry
    seq = ctx.sequence_str()
    out = []
    known = [k for k in seq if k in registry.registered_keys()]
    for k in sorted(set(seq) - set(known)):
        out.append(rule.finding(
            f'pass key {k!r} is not registered — the order DAG cannot '
            f'cover it', where=k, severity='warn'))
    for a, b in planner.theoretical_dag(''.join(known)):
        # edge (a, b): every a must run before any b; with repeats allowed
        # a b occurring before the LAST a is still a violation
        if seq.index(b) < seq.rindex(a):
            pa, pb = registry.get_pass(a), registry.get_pass(b)
            out.append(rule.finding(
                f"sequence {seq!r} runs '{b}' before '{a}', violating the "
                f"theoretical edge {a}→{b} ({pa.name} is "
                f"{pa.kind}/{pa.granularity}, {pb.name} is "
                f"{pb.kind}/{pb.granularity}: static precedes dynamic, "
                f"large granularity precedes small)",
                where=f'{a}->{b}'))
    return out


def _rule_op_traffic(ctx: AnalysisContext, rule: AnalysisRule):
    """The bytes one ``fn`` call writes (every op's outputs outside the
    wrappers, every kernel call's outputs once) stay within
    OP_TRAFFIC_TOL of the per-layer prediction (analysis/traffic.py) — a
    silent activation-traffic regression fails the export."""
    from repro_torch.analysis import traffic
    run = ctx.run('fn')
    measured = run.written_bytes()
    uploads = sum(o.nbytes for o in run.ops if o.transfer == 'h2d')
    pred = traffic.predicted_hbm_bytes(_main_layers(ctx.model),
                                       backend='cuda')
    predicted = pred['predicted_bytes']
    ratio = measured / max(predicted, 1.0)
    terms = sorted(pred['terms'].items(), key=lambda kv: -kv[1])
    out = [rule.finding(
        f'fn writes {measured / 1e6:.6f} MB vs predicted '
        f'{predicted / 1e6:.6f} MB ({ratio:.3f}x: '
        + ', '.join(f'{k} {v / 1e6:.3f}' for k, v in terms)
        + f' MB); {uploads} bytes uploaded from the host', where='fn',
        severity='info')]
    if measured > predicted * (1.0 + OP_TRAFFIC_TOL):
        top = terms[:3]
        out.append(rule.finding(
            f'fn writes {measured / 1e6:.2f} MB, more than the predicted '
            f'{predicted / 1e6:.2f} MB by over {OP_TRAFFIC_TOL:.0%} '
            f'({ratio:.2f}x) — a device-traffic regression shipped '
            f'(largest predicted terms: '
            + ', '.join(f'{k}={v / 1e6:.2f}MB' for k, v in top) + ')',
            where='fn'))
    return out


def _rule_placement_consistency(ctx: AnalysisContext, rule: AnalysisRule):
    """A placed export is internally consistent: every stage is assigned
    exactly one device, the committed per-stage params actually live on
    their assigned devices, and every *cross-device* stage edge streams an
    int8 QAct carry — the pipeline-parallel scheduler's placement
    contract."""
    from repro_torch.core.export import QAct
    out = []
    model = ctx.model
    sd = tuple(model.stage_devices)
    n = model.n_stages
    if len(sd) != n:
        out.append(rule.finding(
            f'placement assigns {len(sd)} of {n} stages — every stage '
            f'must have exactly one device', where='placement'))
    for i, d in enumerate(sd[:n]):
        if d is None or isinstance(d, (tuple, list, set, frozenset)):
            out.append(rule.finding(
                f'stage {i} is assigned {d!r} — exactly one device per '
                f'stage', where=f'stage{i}'))
    sp = getattr(model, 'stage_params', None)
    if sp is None or len(sp) != len(sd):
        out.append(rule.finding(
            'stage_devices declared but stage params are not committed '
            'per stage (place_stages was bypassed)', where='placement'))
    else:
        for i, d in enumerate(sd[:n]):
            if d is None or isinstance(d, (tuple, list, set, frozenset)):
                continue
            leaves = tensors_in(sp[i])
            devs = {leaf.device for leaf in leaves[:1]}
            if devs and devs != {torch.device(d)}:
                out.append(rule.finding(
                    f'stage {i} params committed to {sorted(map(str, devs))}'
                    f' but the stage is placed on {d} — the segment would '
                    f'execute off its assigned device', where=f'stage{i}'))
    # cross-device edges: the streamed carry must be an int8 QAct
    runs = ctx.stage_runs()
    for i in range(min(n - 1, len(sd) - 1)):
        if sd[i] is sd[i + 1] or sd[i] == sd[i + 1]:
            continue
        _, carry = runs[i].out
        if not isinstance(carry, QAct) or carry.q.dtype != torch.int8:
            dts = sorted({str(t.dtype) for t in tensors_in(carry)})
            out.append(rule.finding(
                f'cross-device edge stage {i} ({sd[i]}) -> stage {i + 1} '
                f'({sd[i + 1]}) streams {type(carry).__name__} of dtype '
                f'{dts} — inter-device carries must be int8 QAct '
                f'(fp32 quadruples the transfer bytes)',
                where=f'stage{i}->stage{i + 1}'))
    return out


def _rule_trace_invariants(ctx: AnalysisContext, rule: AnalysisRule):
    """Runtime evidence: a recorded scheduler/export trace must satisfy the
    span invariants (well-formed times, proper nesting, one batch at a
    time per replica, and — with completions — every completion's latency
    equal to its span tree's extent).  The serving rules check a run of
    the export; this one checks an execution the runtime recorded."""
    from repro_torch.obs.validate import check_trace
    try:
        violations = check_trace(ctx.trace, completions=ctx.completions)
    except ValueError as e:               # torn async pair at load time
        violations = [str(e)]
    out = [rule.finding(v, where='trace') for v in violations]
    n = len(getattr(ctx.trace, 'spans', ctx.trace)) \
        if not isinstance(ctx.trace, (str, bytes)) else '?'
    out.append(rule.finding(
        f'{n} spans checked, {len(violations)} invariant violation(s)',
        where='trace', severity='info'))
    return out


def _register_builtin_rules():
    for key, requires, doc, fn in (
        ('int8-residency', ('model', 'plan', 'input'),
         'fp32 only at logit heads / declared fallbacks; zero activation '
         'abs-max and zero weight-scale recompute in calibrated resident '
         'runs; every kernel call consumes int8',
         _rule_int8_residency),
        ('smem-fit', ('model', 'input'),
         "every recorded launch plan's shared memory fits "
         "tiling.SMEM_BUDGET (and the card's opt-in limit on a card)",
         _rule_smem_fit),
        ('launch-budget', ('model', 'plan', 'input'),
         "recorded kernel calls match the layer plan's launch accounting, "
         'per segment too, incl. fused/chained low-rank selections; on a '
         "card the wrappers' counters agree and no plain version runs",
         _rule_launch_budget),
        ('stage-carry', ('model', 'plan', 'stages', 'input'),
         'stage boundaries exchange int8 QAct with static float scales; '
         'no host sync inside a serving segment',
         _rule_stage_carry),
        ('order-dag', ('sequence',),
         "a Pipeline sequence respects planner.theoretical_dag's edges "
         '(reports the violated edge)',
         _rule_order_dag),
        ('op-traffic', ('model', 'plan', 'input'),
         'the bytes one fn call writes within 20% of the per-layer '
         'prediction (analysis/traffic.py)',
         _rule_op_traffic),
        ('placement-consistency', ('model', 'stages', 'placement', 'input'),
         'every stage of a placed export is assigned exactly one device, '
         'stage params are committed where their stage runs, and every '
         'cross-device stage edge streams an int8 QAct carry',
         _rule_placement_consistency),
        ('trace-invariants', ('trace',),
         'a recorded runtime trace satisfies the span invariants: '
         'well-formed nesting, serial per-replica execution, and '
         'completion latencies that match their span extents '
         '(repro_torch.obs.check_trace)',
         _rule_trace_invariants),
    ):
        register_rule(AnalysisRule(key=key, severity='error',
                                   requires=requires, doc=doc, fn=fn))


_register_builtin_rules()
