"""Sharding rules: parameter/optimizer/batch/cache specs (the reference's
``launch/sharding.py``), and their placements on a DeviceMesh.

Megatron-style TP on the 'model' axis (vocab, heads, FFN hidden, experts,
SSD heads, RG-LRU width), FSDP-style parameter sharding over the DP axes
where divisible (params and optimizer states are both far too large to
replicate for the 72B/671B archs), and batch over ('pod','data').  Decode
caches are **sequence-sharded** over 'model' (plus 'data' for the batch=1
long-context cells).

Everything is path-driven over the param tree, so the same rules cover all
10 architectures; per-arch overrides come from cfg (``shard_heads=False``
for whisper's 12 heads).  The trees are the reference's nested dicts and
lists, so a leaf's path keys are the reference's.

A rule returns the reference's spec, a :class:`PartitionSpec`: per dim
None, an axis name or a tuple of axes.  The rules read only a mesh's axis
names and sizes (``mesh.mesh_axes``), so they run on an
``AbstractMesh`` of 256 or 512 ranks with no process group.
:func:`placements` turns a spec into DTensor placements: a dim sharded
over a tuple of axes becomes ``Shard(d)`` on each of those mesh dims;
DTensor splits a dim major to minor in mesh-dim order, so the tuple must
list its axes in the mesh's order, as every rule here does.  A
:class:`NamedSharding` is the reference's (mesh, spec) pair;
``NamedSharding.place`` puts a full tensor onto it (every rank keeps its
chunk).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.launch.mesh import mesh_axes
from repro_torch.tree import tree_map, tree_map_with_path

MODEL = 'model'


class PartitionSpec:
    """Per tensor dim: None, an axis name or a tuple of axis names (the
    reference's ``jax.sharding.PartitionSpec``).  Not a tuple, so the
    tree helpers take it as one leaf; ``tuple(spec)`` gives its dims."""
    __slots__ = ('dims',)

    def __init__(self, *dims):
        self.dims = tuple(dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f'P{self.dims!r}'


P = PartitionSpec


def _axes(s) -> tuple:
    return () if s is None else (s if isinstance(s, tuple) else (s,))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``'s dims, in mesh order:
    ``Shard(d)`` on every mesh dim an axis of ``spec[d]`` names, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        ax = _axes(s)
        idx = [names.index(a) for a in ax]
        if idx != sorted(idx):
            raise ValueError(f'spec {spec}: the axes of dim {d} are not in '
                             f'the mesh order {tuple(names)}')
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, full):
        """``full`` (the whole tensor, the same on every rank) as a
        DTensor on this sharding: each rank keeps its chunk, with no
        collective."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(full.to(self.mesh.device_type), self.mesh,
                                 self.placements, src_data_rank=None)


def _path_keys(path):
    out = []
    for p in path:
        k = getattr(p, 'key', None)
        if k is None:
            k = getattr(p, 'idx', p)
        out.append(str(k))
    return out


def _div(n, mesh, axis) -> bool:
    sizes = mesh_axes(mesh)
    return n % math.prod(sizes[a] for a in _axes(axis)) == 0


def param_spec(path, leaf, cfg, mesh, *, fsdp_axes=()):
    """PartitionSpec for one parameter leaf."""
    keys = _path_keys(path)
    shape = leaf.shape
    stacked = 'blocks' in keys                # scan-stacked: leading G dim
    off = 1 if stacked else 0

    def out(*spec):
        spec = (None,) * off + spec
        # pad/truncate to rank
        spec = (spec + (None,) * len(shape))[:len(shape)]
        # drop shardings that do not divide
        fixed = []
        for dim, s in enumerate(spec):
            if s is not None and not _div(shape[dim], mesh, s):
                s = None
            fixed.append(s)
        # FSDP: shard the largest remaining replicated dim over DP axes
        if fsdp_axes and len(shape) - off >= 2:
            best, best_dim = 0, None
            for dim in range(off, len(shape)):
                if fixed[dim] is None and shape[dim] > best \
                        and _div(shape[dim], mesh, tuple(fsdp_axes)):
                    best, best_dim = shape[dim], dim
            if best_dim is not None and best >= 1024:
                fixed[best_dim] = tuple(fsdp_axes) if len(fsdp_axes) > 1 \
                    else fsdp_axes[0]
        return P(*fixed)

    name = keys[-2] if keys and keys[-1] in ('w', 'b', 'w_q', 'scale') \
        else keys[-1]
    leafname = keys[-1]

    # --- embeddings
    if 'table' in keys:
        return out(MODEL, None)
    # --- attention
    if name in ('wq', 'wk', 'wv') or (len(keys) >= 3 and keys[-3] in
                                      ('wq', 'wk', 'wv')):
        if not cfg.shard_heads:
            return out(None, None)
        return out(None, MODEL) if leafname in ('w', 'w_q') else out(MODEL)
    if name == 'wo' and 'attn' in keys or name == 'wo' and 'xattn' in keys:
        return out(MODEL, None) if leafname in ('w', 'w_q') else out(None)
    # --- MLA
    if name in ('wq_a', 'wkv_a'):
        return out(None, None)
    if name == 'wq_b':
        return out(None, MODEL) if cfg.shard_heads else out(None, None)
    if name in ('wk_b', 'wv_b'):
        return out(None, MODEL, None)             # (r, H, dn/dv): heads
    # --- MoE (expert parallelism over 'model')
    if 'moe' in keys:
        if name == 'router':
            return out(None, None)
        if name in ('wi', 'wg', 'wo') and len(shape) - off == 3:
            return out(MODEL, None, None)
    # --- dense MLP
    if name in ('wi', 'wg'):
        return out(None, MODEL) if leafname in ('w', 'w_q') else out(MODEL)
    if name == 'wo':
        return out(MODEL, None) if leafname in ('w', 'w_q') else out(None)
    # --- RG-LRU
    if 'rglru' in keys:
        if name in ('wgate', 'wx', 'w_r', 'w_i'):
            return out(None, MODEL) if leafname in ('w', 'w_q') else out(MODEL)
        if name == 'conv':
            return out(None, MODEL) if leafname == 'w' else out(MODEL)
        if leafname == 'lam':
            return out(MODEL)
    # --- Mamba-2
    if 'mamba' in keys:
        if name in ('in_proj',):
            return out(None, MODEL) if leafname in ('w', 'w_q') else out(MODEL)
        if name == 'out_proj':
            return out(MODEL, None) if leafname in ('w', 'w_q') else out(None)
        if name == 'conv':
            return out(None, MODEL) if leafname == 'w' else out(MODEL)
        if leafname in ('A_log', 'D', 'dt_bias'):
            return out(MODEL)
        if leafname == 'scale':
            return out(MODEL)
    # --- norms / scalars / everything else: replicated (modulo FSDP)
    return out(None)


def params_shardings(params, cfg, mesh, *, fsdp=True):
    fsdp_axes = tuple(a for a in mesh_axes(mesh) if a != MODEL) if fsdp \
        else ()
    return tree_map_with_path(
        lambda p, x: NamedSharding(mesh, param_spec(p, x, cfg, mesh,
                                                    fsdp_axes=fsdp_axes)),
        params)


def batch_spec(shape, mesh):
    """Shard the leading batch dim over DP axes when divisible."""
    dp = tuple(a for a in mesh_axes(mesh) if a != MODEL)
    if _div(shape[0], mesh, dp):
        return P(dp if len(dp) > 1 else dp[0])
    if len(dp) > 1 and _div(shape[0], mesh, dp[-1]):
        return P(dp[-1])
    return P()


def batch_shardings(batch, mesh):
    return tree_map(lambda x: NamedSharding(mesh, batch_spec(x.shape, mesh)),
                    batch)


# ------------------------------------------------------------- decode caches


def cache_spec(path, leaf, cfg, mesh, *, long_ctx=False):
    """Sequence-sharded KV caches; state caches shard batch/heads."""
    keys = _path_keys(path)
    shape = leaf.shape
    stacked = 'blocks' in keys
    off = 1 if stacked else 0
    dp = tuple(a for a in mesh_axes(mesh) if a != MODEL)
    seq_ax = (dp + (MODEL,)) if long_ctx else (MODEL,)
    bspec = None if long_ctx else (dp if len(dp) > 1 else dp[0])

    def out(*spec):
        spec = (None,) * off + spec
        spec = (spec + (None,) * len(shape))[:len(shape)]
        fixed = []
        for dim, s in enumerate(spec):
            if s is not None and not _div(shape[dim], mesh, s):
                s = None
            fixed.append(s)
        return P(*fixed)

    leafname = keys[-1]
    if leafname in ('k', 'v'):                       # (B, Sc, K, hd)
        return out(bspec, seq_ax if len(seq_ax) > 1 else seq_ax[0])
    if leafname in ('ckv', 'kr'):                    # (B, Sc, r)
        return out(bspec, seq_ax if len(seq_ax) > 1 else seq_ax[0])
    if leafname in ('slots', 'pos'):                 # (Sc,)
        return out(seq_ax if len(seq_ax) > 1 else seq_ax[0])
    if leafname == 'total':
        return out()
    if leafname == 'h' and 'conv' not in keys:       # ssm/rglru state
        if len(shape) - off >= 2:
            return out(bspec, MODEL)                 # (B, h, p, n)/(B, W)
        return out(bspec)
    if leafname == 'conv':                           # (B, k-1, C)
        return out(bspec, None, MODEL)
    return out(bspec)


def cache_shardings(cache, cfg, mesh, *, long_ctx=False):
    return tree_map_with_path(
        lambda p, x: NamedSharding(
            mesh, cache_spec(p, x, cfg, mesh, long_ctx=long_ctx)), cache)


def zero1_shardings(opt_state_shapes, param_shardings_tree, mesh):
    """ZeRO-1: optimizer moments additionally sharded over DP axes."""
    from repro_torch.optim.adamw import AdamWState
    dp = tuple(a for a in mesh_axes(mesh) if a != MODEL)

    def shard_moment(sh, x):
        spec = list(sh.spec) + [None] * (len(x.shape) - len(sh.spec))
        used = set()
        for s in spec:
            for a in (s if isinstance(s, tuple) else (s,)):
                used.add(a)
        free = tuple(a for a in dp if a not in used)
        if not free:
            return NamedSharding(mesh, P(*spec))
        for dim, s in enumerate(spec):
            if s is None and _div(x.shape[dim], mesh, free):
                spec[dim] = free if len(free) > 1 else free[0]
                break
        return NamedSharding(mesh, P(*spec))

    step_sh = NamedSharding(mesh, P())
    mu = tree_map(shard_moment, param_shardings_tree, opt_state_shapes.mu)
    nu = tree_map(shard_moment, param_shardings_tree, opt_state_shapes.nu)
    return AdamWState(step=step_sh, mu=mu, nu=nu)
