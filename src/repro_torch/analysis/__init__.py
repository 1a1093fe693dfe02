"""The analyzer: serving contracts for every export (the reference's
``analysis`` package on PyTorch; see README.md here).

``analysis.check(model, sequence=..., ...)`` enforces the repo's serving
guarantees as registered, typed rules: int8-residency, smem-fit,
launch-budget, stage-carry, order-dag, op-traffic, placement-consistency,
trace-invariants.  Wired into ``export_cnn(..., verify=)``,
``launch/serve_cnn.py --verify``, ``Pipeline.verify_order`` and the
``scripts/ci_torch.sh`` gate (``python -m repro_torch.analysis.gate``),
which also proves every rule live against the deliberately-broken targets
in :mod:`.mutations`.

Where the port departs from the reference: the reference traces jaxprs and
optimized HLO and executes nothing; the port's kernels are ctypes calls
that no tracer sees, so its context runs each serving function once on
the example input, on the model's device, under two recorders (the kernel
wrappers' calls with their launch plans, and a ``TorchDispatchMode`` over
the torch ops outside the wrappers), and every rule reads what they
recorded.  ``vmem-fit`` becomes ``smem-fit`` (the plans' shared memory
against the Hopper budget) and ``hlo-traffic`` becomes ``op-traffic`` (the
bytes the recorded ops and kernel calls write).
"""
from repro_torch.analysis.report import (SEVERITIES, AnalysisError,
                                         AnalysisReport, Finding)
from repro_torch.analysis.rules import (AnalysisContext, AnalysisRule, check,
                                        get_rule, register_rule,
                                        registered_rules, unregister_rule)
from repro_torch.analysis.walker import (OpRecord, OpRecorder, Run,
                                         call_smem_bytes, op_count,
                                         record_run)

__all__ = [
    'SEVERITIES', 'AnalysisError', 'AnalysisReport', 'Finding',
    'AnalysisContext', 'AnalysisRule', 'check', 'get_rule', 'register_rule',
    'registered_rules', 'unregister_rule',
    'OpRecord', 'OpRecorder', 'Run', 'call_smem_bytes', 'op_count',
    'record_run',
]
