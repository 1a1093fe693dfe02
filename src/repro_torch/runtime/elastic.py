"""Elastic scaling: reshard a training state onto a different mesh (the
reference's ``runtime/elastic.py`` on DeviceMesh and DTensor).

When a pod (or any slice) is lost, the job restarts on the surviving
hardware: the checkpoint is loaded as full host arrays and re-placed under
the *new* mesh's placements.  Symmetrically, scale-up re-places onto a
larger mesh.  Batch-size semantics are preserved by keeping the *global*
batch fixed and letting the per-rank batch grow or shrink (the step
function takes the global batch and each rank takes its chunk, so only
placements change, not math).

A sharding is ``launch.sharding.NamedSharding`` (a mesh and the
reference's spec); :func:`reshard_tree` puts each full tensor onto it with
``distribute_tensor(..., src_data_rank=None)``: every rank holds the same
full array (read from the same checkpoint) and keeps its own chunk, with
no collective.  A checkpoint of a sharded state holds full arrays
(``checkpoint/manager.py``), so a run saved on a (2, 2) mesh resumes on
(1, 2) or on one rank.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map, tree_map_with_path


def reshard_tree(tree, shardings):
    """Place every leaf of ``tree`` onto the matching NamedSharding (a
    DTensor leaf is gathered first); leaves whose sharding is None stay as
    they are."""
    from torch.distributed.tensor import DTensor

    def place(x, s):
        if s is None:
            return x
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return s.place(torch.as_tensor(x))
    return tree_map(place, tree, shardings)


def shardings_for(tree, mesh, spec_fn):
    """A sharding tree: ``spec_fn(path, leaf)`` -> the reference's spec."""
    from repro_torch.launch.sharding import NamedSharding
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_fn(path, leaf)), tree)


def elastic_restore(ckpt_manager, tree_like, new_mesh, spec_fn):
    """Restore the latest checkpoint onto a (possibly different-size)
    mesh.  ``tree_like`` gives the structure; its DTensor leaves (of the
    old mesh) are read as plain full arrays.  Returns (tree, step)."""
    from torch.distributed.tensor import DTensor
    plain = tree_map(lambda x: x.to_local() if isinstance(x, DTensor)
                     else x, tree_like)
    state, step = ckpt_manager.restore_latest(plain)
    return reshard_tree(state, shardings_for(state, new_mesh, spec_fn)), step
