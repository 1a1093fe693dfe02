"""Shared block-fitting and budgets for the kernels.

A copy of the reference's tiling rules (same LANE/SUBLANE semantics, so
padding decisions and the serving slot geometry match the JAX package),
plus the Hopper shared-memory budget the CUDA kernels size their tiles
against.

* :func:`fit_block` returns the largest divisor <= the requested block and
  raises once it drops below ``floor`` (prime dims would otherwise degrade
  to 1-wide blocks).
* :func:`pad_to` gives the next multiple of 128.
* :func:`batch_slots` is the scheduler's fixed slot count (multiple of 8).
"""
from __future__ import annotations

LANE = 128          # reference lane width: last-dim tiles are 128 wide
SUBLANE = 8         # reference sublane width: second-minor tiles pack 8 rows

# The reference's per-kernel resident-block budget (half of a TPU v5e
# core's VMEM).  Kept because the port mirrors the reference's routing
# decisions that depend on it (ops.fake_quant's fused-vs-two-pass gate).
VMEM_BUDGET = 8 * 2 ** 20

# Shared memory one thread block may use on an H100 (227 KB of the SM's
# 256 KB; above 48 KB only as opt-in dynamic shared memory).
SMEM_BUDGET = 227 * 1024


def pad_to(dim: int, mult: int = LANE) -> int:
    """Next multiple of ``mult`` >= dim (dim itself when it already is)."""
    return -(-dim // mult) * mult


def batch_slots(n: int, mult: int = SUBLANE) -> int:
    """Serving batch geometry: the slot count for ``n`` concurrent requests.

    The scheduler pads its slot count up to this and keeps it FIXED across
    rounds, so per-slot results are independent of how the other slots
    are filled (the scheduler's bit-exactness contract).
    """
    return pad_to(max(int(n), 1), mult)


def fit_block(block: int, dim: int, *, floor: int = 8) -> int:
    """Largest divisor of ``dim`` that is <= ``block``.

    Raises ValueError when the best divisor is smaller than
    ``min(floor, dim)``; callers pad the dim to ``pad_to(dim)`` first.
    """
    if dim <= 0:
        raise ValueError(f'cannot tile empty dim {dim}')
    b = min(block, dim)
    while dim % b:
        b -= 1
    if b < min(floor, dim):
        raise ValueError(
            f'no usable block <= {block} for dim {dim} (best divisor {b}); '
            f'pad the dim to {pad_to(dim)} (next multiple of {LANE})')
    return b


def fit_or_pad(block: int, dim: int, *, floor: int = 8) -> tuple[int, int]:
    """(block, padded_dim): like :func:`fit_block`, but instead of raising,
    returns the block for the 128-padded dim (padded_dim == dim when the
    original dim already tiles cleanly)."""
    try:
        return fit_block(block, dim, floor=floor), dim
    except ValueError:
        p = pad_to(dim)
        return fit_block(block, p, floor=floor), p
