"""Structured output of the analyzer: findings + report (a copy of the
reference's ``analysis/report.py``).

A :class:`Finding` is one checked fact about an export (or a pass
sequence): which rule produced it, how bad it is, where it points.  An
:class:`AnalysisReport` is the result of one ``analysis.check(...)`` run —
attached to ``ServingModel.summary()``, printed by
``launch/serve_cnn.py --verify``, and gated on by ``scripts/ci_torch.sh``
(``python -m repro_torch.analysis.gate`` fails on any error-severity
finding).
"""
from __future__ import annotations

from dataclasses import dataclass, field

SEVERITIES = ('error', 'warn', 'info')


@dataclass(frozen=True)
class Finding:
    """One analyzer observation.  ``where`` names the layer / kernel /
    sequence position the finding anchors to (None for whole-graph facts)."""
    rule: str
    severity: str          # 'error' | 'warn' | 'info'
    message: str
    where: str | None = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f'unknown severity {self.severity!r} '
                             f'(one of {SEVERITIES})')

    def to_dict(self) -> dict:
        d = {'rule': self.rule, 'severity': self.severity,
             'message': self.message}
        if self.where is not None:
            d['where'] = self.where
        return d

    def __str__(self):
        loc = f' [{self.where}]' if self.where else ''
        return f'{self.severity.upper():5s} {self.rule}{loc}: {self.message}'


class AnalysisError(RuntimeError):
    """Raised by strict verification when error-severity findings exist.
    Carries the full report as ``.report``."""

    def __init__(self, report: 'AnalysisReport'):
        self.report = report
        errs = '\n'.join(f'  {f}' for f in report.errors)
        super().__init__(
            f'{len(report.errors)} error-severity analysis finding(s):\n'
            f'{errs}')


@dataclass(frozen=True)
class AnalysisReport:
    """The outcome of one analyzer run over a target."""
    findings: tuple = ()
    checked: tuple = ()        # rule keys that actually ran
    skipped: tuple = ()        # (rule key, reason) for rules that could not
    target: str = ''           # e.g. the exported config name

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == 'error')

    @property
    def warnings(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == 'warn')

    @property
    def ok(self) -> bool:
        """True iff no error-severity finding survived."""
        return not self.errors

    def by_rule(self, key: str) -> tuple:
        return tuple(f for f in self.findings if f.rule == key)

    def raise_if_errors(self) -> 'AnalysisReport':
        if not self.ok:
            raise AnalysisError(self)
        return self

    def to_dict(self) -> dict:
        return {'ok': self.ok,
                'target': self.target,
                'checked': list(self.checked),
                'skipped': [list(s) for s in self.skipped],
                'findings': [f.to_dict() for f in self.findings]}

    def __str__(self):
        head = (f'analysis[{self.target or "?"}]: '
                f'{"OK" if self.ok else "FAIL"} '
                f'({len(self.errors)} errors, {len(self.warnings)} warnings; '
                f'rules run: {", ".join(self.checked) or "none"})')
        lines = [head] + [f'  {f}' for f in self.findings]
        lines += [f'  SKIP  {k}: {why}' for k, why in self.skipped]
        return '\n'.join(lines)
