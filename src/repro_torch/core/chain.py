"""CompressionChain: apply passes in a given order, the paper's pipeline
(the reference's ``core/chain.py``).

``Pipeline`` is the chain API over the pass registry (core/registry.py):

    Pipeline.from_sequence('DPLQE', hps).run(family, cfg, trainer)
    Pipeline.auto(planner).run(...)        # order from pairwise experiments

``from_sequence`` validates the sequence against the registry (unknown
keys, duplicates) and resolves each pass's hyperparameters into its typed
dataclass up front: an ``hps`` entry whose key is not in the sequence, or
a misspelled hyperparameter name, raises instead of being ignored.
``run`` trains the baseline (unless a shared one is passed), applies each
pass with fine-tuning, and records (accuracy, BitOpsCR, CR) after every
stage: the data behind the paper's Fig. 15 and Tables 1-4.

The chain runs for both families: a CNN (``CNNFamily``) and the dense LM
decoder (``LMFamily``), and ``Pipeline.export`` compiles either for
serving.

Where the port departs from the reference: ``Pipeline.export`` takes the
port's ``device`` in place of ``use_pallas``, as ``export_cnn`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.core import registry
from repro_torch.core.passes import ChainState, Trainer, init_chain_state

OPTIMAL_SEQUENCE = 'DPQE'   # the paper's own 4-pass combinational law


@dataclass(frozen=True)
class Pipeline:
    """A validated, hp-resolved sequence of registered compression passes."""
    steps: tuple     # ((CompressionPass, typed hp), ...)

    @classmethod
    def from_sequence(cls, sequence: str, hps: dict | None = None, *,
                      allow_repeats: bool = False,
                      verify_order: bool = False) -> 'Pipeline':
        """Build from a key string like 'DPLQE' and optional per-key hps.

        ``hps`` maps pass key -> dict or typed hp dataclass.  Raises on
        unknown pass keys, on hps entries for keys not in the sequence
        (typo guard), and on duplicate keys unless ``allow_repeats=True``
        (the repeat-compression experiments opt in deliberately).
        ``verify_order=True`` additionally lints the sequence against the
        theoretical order DAG (the analyzer's order-dag rule) and raises
        :class:`~repro_torch.analysis.AnalysisError` naming the violated
        edge; it is opt-in because the pairwise experiments run wrong
        orders on purpose.
        """
        hps = dict(hps or {})
        seq = list(sequence)
        if not seq:
            raise ValueError('empty pass sequence')
        dups = sorted({k for k in seq if seq.count(k) > 1})
        if dups and not allow_repeats:
            raise ValueError(
                f'duplicate pass keys {dups} in sequence {sequence!r}; '
                f'pass allow_repeats=True if the repetition is intended')
        stray = sorted(set(hps) - set(seq))
        if stray:
            raise ValueError(
                f'hps given for keys {stray} not in sequence {sequence!r} '
                f'(registered passes: {registry.registered_keys()})')
        steps = tuple((p, p.resolve_hp(hps.get(k)))
                      for k in seq for p in (registry.get_pass(k),))
        pipe = cls(steps)
        if verify_order:
            pipe.verify_order(strict=True)
        return pipe

    def verify_order(self, *, strict: bool = False):
        """Lint this pipeline's sequence against the theoretical order DAG
        (the analyzer's order-dag rule) and return the AnalysisReport;
        ``strict=True`` raises AnalysisError on a violated edge."""
        from repro_torch.analysis import check
        return check(sequence=self, rules=('order-dag',), strict=strict,
                     target=f'Pipeline {self.sequence!r}')

    @classmethod
    def auto(cls, planner, hps: dict | None = None) -> 'Pipeline':
        """Order from an OrderPlanner's pairwise DAG (or a benchmark results
        dict carrying 'topological_order')."""
        if hasattr(planner, 'topological_order'):
            seq = planner.topological_order()
        else:
            seq = planner['topological_order']
        return cls.from_sequence(seq, hps)

    @property
    def sequence(self) -> str:
        return ''.join(p.key for p, _ in self.steps)

    def run(self, family, cfg, trainer: Trainer, *, key=None,
            state: ChainState | None = None,
            pretrain_steps=None, checkpoint_dir=None) -> ChainState:
        """Apply the passes in order, fine-tuning and recording metrics.

        Returns the final ChainState; ``state.history`` holds per-stage
        metrics.  Pass an existing baseline ``state`` to reuse one trained
        original model across different sequences (how the paper compares
        orders fairly).  ``key`` (an integer seed, default 0) seeds the
        baseline.

        ``checkpoint_dir`` persists the ChainState after the baseline and
        after every pass (checkpoint/chain_io.py: atomic step dirs, step =
        passes applied) and RESUMES from the newest committed step on the
        next call: a preempted chain re-runs only the pass it died in.  A
        passed-in ``state`` takes precedence over any checkpoint on disk.
        """
        start = 0
        if state is None and checkpoint_dir is not None:
            from repro_torch.checkpoint.chain_io import load_chain_state
            from repro_torch.checkpoint.manager import latest_step
            if latest_step(checkpoint_dir) is not None:
                state, start = load_chain_state(checkpoint_dir, family)
                if start > len(self.steps):
                    raise ValueError(
                        f'checkpoint at {checkpoint_dir} has {start} passes '
                        f'applied but this pipeline only runs '
                        f'{len(self.steps)} ({self.sequence!r})')
                # the chain on disk must be a prefix of THIS pipeline: the
                # history has one entry per applied pass, so its last
                # `start` labels must equal this sequence's first keys
                applied = [h.get('pass')
                           for h in state.history][-start:] if start else []
                want = [p.key for p, _ in self.steps[:start]]
                if applied != want:
                    raise ValueError(
                        f'checkpoint at {checkpoint_dir} was produced by '
                        f'passes {applied} but this pipeline starts with '
                        f'{want} ({self.sequence!r}); use a fresh '
                        f'checkpoint_dir')
        if state is None:
            state = init_chain_state(family, cfg, 0 if key is None else key,
                                     trainer, pretrain_steps=pretrain_steps)
            self._save(checkpoint_dir, state, 0)
        for i, (p, hp) in enumerate(self.steps):
            if i < start:
                continue                         # already applied on disk
            state = p.fn(state, hp, trainer)     # hp already resolved
            state.metrics(trainer, p.key)
            self._save(checkpoint_dir, state, i + 1)
        return state

    @staticmethod
    def _save(checkpoint_dir, state, step):
        if checkpoint_dir is not None:
            from repro_torch.checkpoint.chain_io import save_chain_state
            save_chain_state(checkpoint_dir, state, step=step)

    def export(self, state: ChainState, *, device='cuda') -> Any:
        """Compile the finished chain for serving on ``device`` through
        the family's registered backend (``export.export_chain``): a CNN
        with dynamic activation scales (``export_cnn(calibrate=None)``;
        ``export_chain(state, calibrate=...)`` gives the int8-resident
        plan), an LM as int8 weights (``export_lm``)."""
        from repro_torch.core.export import export_chain
        return export_chain(state, device=device)


def run_chain(family, cfg, sequence: str, hps: dict, trainer: Trainer, *,
              key=None, state: ChainState | None = None,
              pretrain_steps=None, allow_repeats: bool = False):
    """Apply ``sequence`` (e.g. 'DPQE'). hps: {pass_key: hp dict/dataclass}.

    Thin wrapper over :class:`Pipeline`: see its docstrings for validation
    and reuse semantics.
    """
    pipe = Pipeline.from_sequence(sequence, hps, allow_repeats=allow_repeats)
    return pipe.run(family, cfg, trainer, key=key, state=state,
                    pretrain_steps=pretrain_steps)


def sweep_exit_thresholds(state: ChainState, trainer: Trainer, thresholds):
    """Each trained early-exit model yields a frontier over thresholds
    (the paper: 'each case with Early Exit provides several samples')."""
    fam = state.family
    batches = fam.eval_batches(trainer.eval_n, trainer.eval_batch)
    out = []
    for t in thresholds:
        acc, probs = fam.exit_stats(state.params, state.cfg, batches, t)
        bops = fam.bitops(state.cfg, probs, state.mac_scale)
        out.append({'threshold': t, 'acc': acc,
                    'BitOpsCR': state.base_bitops / max(bops, 1)})
    return out
