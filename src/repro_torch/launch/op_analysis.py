"""Per-rank counts of one step: FLOPs, bytes written, collective bytes and
memory (the counterpart of the reference's ``launch/hlo_analysis.py``).

The reference compiles a step and reads the optimized HLO of one
partition.  The port has no HLO: a step is one eager program per rank, so
this module counts what one rank's call dispatches, op by op, under one
recorder (:class:`OpAnalysis`, a ``TorchDispatchMode``).  Hence the name:
the analyzer renamed its ``hlo-traffic`` rule ``op-traffic`` for the same
reason.  The call runs on fake tensors (:func:`fake_mode`, a
``FakeTensorMode`` under the recorder), so a 671B-parameter step at full
size allocates nothing; on real tensors it counts the same op stream.

* ``flops``: products and convolutions by ``torch.utils.flop_counter``'s
  convention, which is ``hlo_analysis``'s too (2 x |out| x the contracted
  size), over the forward, the backward and the recomputation of a
  rematerialized layer.  A ``FlopCounterMode`` runs inside the recorder,
  so the count equals ``FlopCounterMode`` over the same call.
* ``bytes``: what each op writes, by ``analysis/walker.py``'s rule (every
  output that owns new storage or that an in-place op writes; a view
  writes nothing).  Eager torch writes every intermediate that XLA would
  keep inside a fusion, so this figure is not comparable to the
  reference's fused proxy, and no test compares the two.
* ``collectives``: operand bytes by kind under ``hlo_analysis``'s names
  (``COLL_KINDS``), over every c10d collective the rank issues: the
  mesh policy's own over 'model' (``models/tp.py``), DTensor's
  redistributions (the per-layer FSDP gathers, ZeRO-1's), the gradient
  reductions, the MoE all-to-alls.  ``collectives_by_axis`` splits each
  kind by the mesh axis whose process group it ran over.  A point-to-point
  send counts as a ``collective-permute`` (its receive as nothing), and
  DTensor's ``shard_dim_alltoall`` as an ``all-to-all`` (on the CPU,
  where gloo has none, DTensor runs an all-gather and a chunk instead,
  counted so); a collective of any other kind raises, so nothing is left
  out.
* ``memory``: the reference reads ``compiled.memory_analysis()``.  Here
  every storage the call creates adds its bytes to a running total when
  it first appears as an op's output, and a finaliser on the storage takes
  them off when it is freed.  ``argument_bytes``: the storages of the
  arguments (this rank's params, optimizer state, batch or cache shards);
  ``output_bytes``: the storages the outputs hold; ``alias_bytes``: those
  of them that are argument storages, written in place (AdamW's update,
  the cache's); ``temp_bytes``: the peak over the call of the bytes of
  live storages that are not arguments.
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLL_KINDS = ('all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
              'collective-permute')

#: c10d and functional-collective ops (schema name without namespace)
#: -> their kind
_KINDS = {
    'allreduce_': 'all-reduce', 'allreduce_coalesced_': 'all-reduce',
    'all_reduce': 'all-reduce', 'all_reduce_': 'all-reduce',
    'all_reduce_coalesced': 'all-reduce',
    'allgather_': 'all-gather', '_allgather_base_': 'all-gather',
    'allgather_into_tensor_coalesced_': 'all-gather',
    'all_gather_into_tensor': 'all-gather',
    'all_gather_into_tensor_coalesced': 'all-gather',
    'all_gather_into_tensor_out': 'all-gather',
    'reduce_scatter_': 'reduce-scatter',
    '_reduce_scatter_base_': 'reduce-scatter',
    'reduce_scatter_tensor_coalesced_': 'reduce-scatter',
    'reduce_scatter_tensor': 'reduce-scatter',
    'reduce_scatter_tensor_coalesced': 'reduce-scatter',
    'alltoall_': 'all-to-all', 'alltoall_base_': 'all-to-all',
    'all_to_all_single': 'all-to-all',
    'send': 'collective-permute', 'isend': 'collective-permute',
    # DTensor's Shard(i) -> Shard(j) on the card (on the CPU it falls
    # back to an all-gather and a chunk, counted as such)
    'shard_dim_alltoall': 'all-to-all',
}
#: the namespaces of collective ops
_NAMESPACES = ('c10d', '_c10d_functional', '_c10d_functional_autograd',
               '_dtensor')
#: ops of those namespaces that move nothing of their own
_NOT_COLLECTIVES = ('wait_tensor', 'recv_', 'irecv', '_wrap_tensor_autograd',
                    'mesh_get_process_group')
#: the schema's operand argument, by name
_OPERANDS = ('tensors', 'input_tensors', 'input_tensor', 'inputs', 'input')


def fake_mode():
    """The fake-tensor mode a dry-run builds its arguments in and runs its
    step under (real tensors the mesh code makes for itself are let in)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _local(t):
    """A DTensor's local tensor, any other tensor as it is."""
    return getattr(t, '_local_tensor', t)


def _nbytes(value) -> int:
    from repro_torch.kernels import tensors_in
    return sum(t.numel() * t.element_size()
               for t in map(_local, tensors_in(value)))


def _group_name(func, args, kwargs):
    import torch.distributed as dist
    for a, v in zip(func._schema.arguments, args):
        if a.name == 'process_group':
            return dist.ProcessGroup.unbox(v).group_name
        if a.name == 'group_name':
            return v
    return kwargs.get('group_name')


@functools.lru_cache(maxsize=None)
def _kind(func):
    """The ``COLL_KINDS`` kind of the op ``func``, None for an op that is
    no collective; raises for a collective of no such kind."""
    ns, _, name = func._schema.name.partition('::')
    if ns not in _NAMESPACES or name in _NOT_COLLECTIVES:
        return None
    if name not in _KINDS:
        raise ValueError(f'{func._schema.name}: a collective of no kind in '
                         f'{COLL_KINDS}')
    return _KINDS[name]


def collective(func, args, kwargs):
    """``(kind, operand bytes, group name)`` of a collective op, None for
    any other op."""
    kind = _kind(func)
    if kind is None:
        return None
    operand = next(v for a, v in zip(func._schema.arguments, args)
                   if a.name in _OPERANDS)
    return kind, _nbytes(operand), _group_name(func, args, kwargs)


class OpAnalysis(TorchDispatchMode):
    """The recorder: enter it (inside :func:`fake_mode` for a dry-run),
    give it the call's arguments (:meth:`arguments`), make the call, give
    it the outputs (:meth:`outputs`) and read :meth:`result`.  ``mesh``
    names the process groups' axes in ``collectives_by_axis`` (a group of
    no mesh dim is ``'other'``)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.axes = {} if mesh is None else {
            mesh.get_group(i).group_name: n
            for i, n in enumerate(mesh.mesh_dim_names)}
        self.bytes = 0
        self.coll = collections.Counter()
        self.by_axis = collections.defaultdict(collections.Counter)
        self.live = {}            # storage key -> bytes
        self.args = set()         # storage keys of the arguments
        self.cur = self.peak = 0  # live bytes beyond the arguments
        self.out_bytes = self.alias_bytes = 0
        self._finalizers = []
        self._flops = None

    # ---------------------------------------------------------- storages

    def _free(self, key):
        n = self.live.pop(key, 0)
        if key not in self.args:
            self.cur -= n

    def _track(self, t) -> int:
        """Register the storage of tensor ``t``; returns its key."""
        s = _local(t).untyped_storage()
        key = s._cdata
        if key not in self.live:
            n = s.nbytes()
            self.live[key] = n
            self.cur += n
            self.peak = max(self.peak, self.cur)
            f = weakref.finalize(s, self._free, key)
            f.atexit = False
            self._finalizers.append(f)
        return key

    def arguments(self, *trees):
        """Register the storages of every tensor in ``trees`` as the
        call's arguments."""
        from repro_torch.kernels import tensors_in
        for t in tensors_in(list(trees)):
            key = self._track(t)
            if key not in self.args:
                self.args.add(key)
                self.cur -= self.live[key]
        self.peak = self.cur

    def outputs(self, out):
        """Register the call's outputs (while they are live)."""
        from repro_torch.kernels import tensors_in
        keys = {self._track(t) for t in tensors_in(out)}
        self.out_bytes = sum(self.live[k] for k in keys)
        self.alias_bytes = sum(self.live[k] for k in keys if k in self.args)

    # ---------------------------------------------------------- dispatch

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._flops.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.analysis.walker import written_bytes
        from repro_torch.kernels import tensors_in
        kwargs = kwargs or {}
        coll = collective(func, args, kwargs)
        out = func(*args, **kwargs)
        ins = [_local(t) for t in tensors_in(args) + tensors_in(kwargs)]
        outs = [_local(t) for t in tensors_in(out)]
        self.bytes += written_bytes(func, ins, outs)
        for t in outs:
            self._track(t)
        if coll is not None:
            kind, n, group = coll
            self.coll[kind] += n
            self.by_axis[kind][self.axes.get(group, 'other')] += n
        return out

    # ------------------------------------------------------------ result

    def result(self) -> dict:
        """``{'flops', 'bytes', 'collectives', 'collectives_by_axis',
        'memory'}`` (module docstring)."""
        for f in self._finalizers:
            f.detach()
        arg_bytes = sum(self.live.get(k, 0) for k in self.args)
        return {
            'flops': float(self._flops.get_total_flops()),
            'bytes': float(self.bytes),
            'collectives': {k: float(self.coll[k]) for k in COLL_KINDS
                            if k in self.coll},
            'collectives_by_axis': {k: {a: float(n) for a, n in v.items()}
                                    for k, v in self.by_axis.items()},
            'memory': {
                'argument_bytes': int(arg_bytes),
                'output_bytes': int(self.out_bytes),
                'temp_bytes': int(self.peak),
                'alias_bytes': int(self.alias_bytes),
            }}


def analyze(fn, *args, mesh=None) -> dict:
    """Call ``fn(*args)`` once under :class:`OpAnalysis` and return its
    :meth:`~OpAnalysis.result` (the reference's ``analyze(hlo)``).  For a
    dry-run, enter :func:`fake_mode` first and make ``args`` in it."""
    with OpAnalysis(mesh) as rec:
        rec.arguments(*args)
        rec.outputs(fn(*args))
    return rec.result()
