#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port (src/repro_torch), on the CPU:
# the analyzer's gate (clean exports green, every rule's mutant caught),
# the quickstart's smoke (the registry and a tiny P->L->Q chain to int8),
# then the port's tests (each imports the JAX reference it is held to).
# Exits non-zero if any fails.  On a machine with a card, run
# `python -m repro_torch.analysis.gate` (default --device cuda) and
# `python -m pytest -q -m gpu tests/test_torch_gpu.py` as well.
set -uo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=${JAX_PLATFORMS:-cpu}

python -m repro_torch.analysis.gate --device cpu
gate=$?
python -m repro_torch.examples.quickstart --smoke --device cpu
smoke=$?
python -m pytest -q tests/test_torch_*.py
tests=$?
echo "ci_torch.sh: gate rc=$gate, quickstart smoke rc=$smoke, tests rc=$tests"
[ "$gate" -eq 0 ] && [ "$smoke" -eq 0 ] && [ "$tests" -eq 0 ]
