# Importing any core submodule fills the compression-pass registry
# (core/registry.py) with the built-in passes: D/P/Q/E from core/passes.py
# and the low-rank 'L' pass from core/lowrank.py.
from repro_torch.core import lowrank as _lowrank    # noqa: F401  (L)
from repro_torch.core import passes as _passes      # noqa: F401  (D P Q E)
