"""The op and kernel-call recorder every rule reads: the port's counterpart
of the reference's jaxpr walker (``walk_eqns``, ``prim_count``,
``pallas_calls``).

The reference traces a jaxpr and executes nothing.  The port's kernels are
ctypes calls that no tracer sees, so :func:`record_run` runs a serving
function once under two recorders:

* ``kernels.recording()``: one :class:`~repro_torch.kernels.KernelCall`
  per kernel wrapper call, on either branch (the card's kernel or its
  plain version on the CPU), with the launch plan the wrapper computes;
* :class:`OpRecorder`, a ``TorchDispatchMode``: one :class:`OpRecord` per
  torch op outside the wrappers.  Inside a wrapper it records nothing, so
  a plain version's own ops (the fp32 ``conv2d`` in
  ``ref.depthwise_conv_ref``) never count as serving-graph ops; the
  wrapper's outputs count once, from its call record.

An op's ``nbytes`` is what it writes: each output tensor that owns new
storage, or that an in-place op writes; a view writes nothing.  A host
sync is ``.item()`` (``aten._local_scalar_dense``) or a copy from the card
to the host; a copy from the host to the card is an upload, kept apart.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.kernels import tensors_in


class OpRecord(NamedTuple):
    """One torch op outside the kernel wrappers."""
    name: str             # 'aten.add'
    dtypes: tuple         # the outputs' dtypes
    nbytes: int           # bytes the op wrote
    device: str           # the first output's device type ('cuda', 'cpu')
    transfer: str | None  # 'd2h' (a host sync), 'h2d' (an upload) or None


class Run(NamedTuple):
    """One recorded call of a serving function."""
    out: Any
    calls: tuple          # KernelCall, in call order
    ops: tuple            # OpRecord, in dispatch order

    def written_bytes(self) -> int:
        """Bytes the call wrote to device memory: every op's outputs but
        the host uploads, and every kernel call's outputs once."""
        return sum(o.nbytes for o in self.ops if o.transfer != 'h2d') + \
            sum(c.out_bytes for c in self.calls)


_SYNC_OPS = ('aten._local_scalar_dense', 'aten.item')


def _storage(t) -> int:
    """The identity of ``t``'s storage (a fake tensor's too, whose data
    pointer is 0); 0 for an empty tensor."""
    return t.untyped_storage()._cdata if t.numel() else 0


@functools.lru_cache(maxsize=None)
def _writes(func) -> tuple:
    """Per return of ``func``: whether it writes an input in place."""
    return tuple(r.alias_info is not None and r.alias_info.is_write
                 for r in func._schema.returns)


def written_bytes(func, ins, outs) -> int:
    """Bytes the op ``func`` wrote, given its input and output tensors:
    each output that owns new storage, or that the op writes in place; a
    view writes nothing."""
    shared = {_storage(t) for t in ins} - {0}
    writes = _writes(func)
    nbytes = 0
    for i, t in enumerate(outs):
        if (i < len(writes) and writes[i]) or _storage(t) not in shared:
            nbytes += t.numel() * t.element_size()
    return nbytes


def _op_record(func, args, kwargs, out) -> OpRecord:
    name = func._schema.name.replace('::', '.')
    ins = tensors_in(args) + tensors_in(kwargs)
    outs = tensors_in(out)
    nbytes = written_bytes(func, ins, outs)
    dev = outs[0].device.type if outs else \
        (ins[0].device.type if ins else 'cpu')
    in_cuda = any(t.is_cuda for t in ins)
    transfer = None
    if name in _SYNC_OPS or (outs and in_cuda and not outs[0].is_cuda):
        transfer = 'd2h'
    elif outs and outs[0].is_cuda and ins and not in_cuda:
        transfer = 'h2d'
    return OpRecord(name, tuple(t.dtype for t in outs), nbytes, dev,
                    transfer)


class OpRecorder(TorchDispatchMode):
    """Records every torch op dispatched while it is active and no kernel
    wrapper call is in progress; use it through :func:`record_run`, which
    also opens the kernel-call recording the wrappers report to."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not kernels.inside_wrapper():
            self.ops.append(_op_record(func, args, kwargs, out))
        return out


def record_run(fn, *args) -> Run:
    """Call ``fn(*args)`` once under both recorders."""
    with kernels.recording() as calls, OpRecorder() as rec:
        out = fn(*args)
    return Run(out, tuple(calls), tuple(rec.ops))


def op_count(ops, *names) -> int:
    """Number of recorded ops called one of ``names`` ('aten.amax')."""
    return sum(1 for o in ops if o.name in names)


def call_smem_bytes(call) -> int | None:
    """Shared memory one block of a recorded kernel call asks for at
    launch, from the plan its wrapper computed (None: a kernel whose
    shared memory is static, sized by its compiler).  Replaces the
    reference's ``pallas_call_vmem_bytes``."""
    return call.smem_bytes
