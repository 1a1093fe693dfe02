#!/usr/bin/env bash
# CI entry point of the PyTorch/CUDA port (src/repro_torch), on the CPU:
# the analyzer's gate (clean exports green, every rule's mutant caught),
# then the port's tests (each imports the JAX reference it is held to).
# Exits non-zero if either fails.  On a machine with a card, run
# `python -m repro_torch.analysis.gate` (default --device cuda) and
# `python -m pytest -q -m gpu tests/test_torch_gpu.py` as well.
set -uo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=${JAX_PLATFORMS:-cpu}

python -m repro_torch.analysis.gate --device cpu
gate=$?
python -m pytest -q tests/test_torch_*.py
tests=$?
echo "ci_torch.sh: gate rc=$gate, tests rc=$tests"
[ "$gate" -eq 0 ] && [ "$tests" -eq 0 ]
