"""Low-rank factorization pass 'L' (the reference's ``core/lowrank.py``).

SVD-splits conv and fc weights into a rank-``r`` pair (a spatial conv down
to ``r`` channels followed by a 1x1 conv back up; for fc, two chained
matmuls), with ``r`` the smallest rank keeping ``energy`` of the spectral
energy, factored only where it saves MACs.  A fine-tune at lr/10 follows,
like every static pass.  The family's ``factorize`` hook does the work and
reports the stage-MAC multiplier for the BitOps cost model; storage is
physical (the factored tree holds fewer parameters).

On the paper's axes: static and sub-neuron, the class of Q; the registry
breaks that tie by key (L before Q), giving the 5-pass law D->P->L->Q->E.
This module registers through the public registry API only, as an
out-of-tree pass would.  The key it leaves is ``fold_in(key, 7)``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core import registry
from repro_torch.core.passes import ChainState, Trainer, fold_in


@dataclass(frozen=True)
class LowRankHP:
    energy: float = 0.95     # fraction of spectral energy the rank must keep
    min_rank: int = 4        # floor on the kept rank


def _lowrank(state: ChainState, hp: LowRankHP, trainer: Trainer) -> ChainState:
    fam = state.family
    params, cfg, scale = fam.factorize(state.params, state.cfg,
                                       energy=hp.energy,
                                       min_rank=hp.min_rank)
    params, _ = trainer.fit(fam, cfg, params, lr=trainer.lr / 10)
    # factorization rewrites the layer topology: exit statistics (if any)
    # are stale, as after P
    return replace(state, cfg=cfg, params=params,
                   lowrank_scale=state.lowrank_scale * scale,
                   key=fold_in(state.key, 7), exit_probs=None,
                   dyn_accuracy=None)


registry.register(registry.CompressionPass(
    'L', 'low-rank', 'static', 'sub-neuron', LowRankHP, _lowrank))
