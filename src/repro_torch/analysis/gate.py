"""CI verify gate: ``PYTHONPATH=src python -m repro_torch.analysis.gate
[--device cuda|cpu]`` (default ``cuda``: the card, as every entry point of
the port).

Green side: exports resnet8, vgg8 and mobilenet-small with exit heads,
and resnet8 low-rank factored (also with exit heads), at W8A8 on the given
device, plus the registry's theoretical pass order, and requires zero
error-severity findings.

Red side: every registered builtin rule must CATCH its mutation fixture
(:mod:`repro_torch.analysis.mutations`), built and checked on the CPU.  A
rule that stops firing — a recorder regression, a loosened threshold, a
skipped requirement — fails CI here even though all shipped exports
still look clean.

Exit status 0 iff both sides hold.  scripts/ci_torch.sh runs this (on the
CPU) before the port's tests.
"""
from __future__ import annotations

import argparse
import sys


def _clean_targets(device):
    import torch

    from repro_torch.analysis import check
    from repro_torch.configs.cnn import (MOBILENET_SMALL_CIFAR, RESNET8_CIFAR,
                                         VGG8_CIFAR)
    from repro_torch.core import planner
    from repro_torch.core.export import export_cnn
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages

    fam = CNNFamily(SyntheticImages(), device='cpu')
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    reports = []
    for base, factorize in ((RESNET8_CIFAR, False), (VGG8_CIFAR, False),
                            (MOBILENET_SMALL_CIFAR, False),
                            (RESNET8_CIFAR, True)):
        params = fam.init(torch.Generator().manual_seed(0), base)
        cfg, tag = base, ''
        if factorize:
            params, cfg, _ = fam.factorize(params, cfg, energy=0.6,
                                           min_rank=2)
            tag = '-factored'
        params, cfg = fam.add_exits(torch.Generator().manual_seed(2), params,
                                    cfg, fam.default_exit_points(cfg))
        cfg = cfg.replace(w_bits=8, a_bits=8)
        model = export_cnn(params, cfg, device=device, calibrate=x)
        reports.append(check(model, x=x,
                             target=f'{cfg.name}{tag}[{model.backend}]'))
    reports.append(check(sequence=planner.theoretical_order()))
    return reports


def _mutant_reports():
    from repro_torch.analysis import check
    from repro_torch.analysis.mutations import MUTANTS
    return {key: check(**factory()) for key, factory in MUTANTS.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                    help='where the clean exports run (the mutants always '
                         'run on the CPU)')
    args = ap.parse_args(argv)
    from repro_torch.analysis import registered_rules
    from repro_torch.analysis.mutations import MUTANTS
    from repro_torch.core.export import resolve_device
    device = resolve_device(args.device)
    ok = True
    print(f'== verify: shipped exports must be clean ({device}) ==')
    for report in _clean_targets(device):
        print(report)
        if not report.ok:
            ok = False
    print('\n== verify: mutated targets must FAIL their rule (cpu) ==')
    if set(MUTANTS) != set(registered_rules()):
        print(f'mutants {sorted(MUTANTS)} do not cover the registered '
              f'rules {registered_rules()}')
        ok = False
    for key, report in _mutant_reports().items():
        caught = any(f.severity == 'error' for f in report.by_rule(key))
        verdict = 'caught' if caught else 'MISSED (rule is dead!)'
        print(f'{report.target}: {verdict}')
        if not caught:
            print(report)
            ok = False
    print(f'\nanalysis gate: {"PASS" if ok else "FAIL"}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
