"""Serving model registry: named endpoints over exported artifacts (the
reference's ``serving/registry.py``; ``device`` takes the place of the
reference's ``use_pallas``, as in ``export_chain``).

The runtime's front door: a finished chain is persisted with
``checkpoint.save_chain_state`` (what ``Pipeline.run(checkpoint_dir=...)``
writes after every pass), and the registry turns such an artifact back
into a live :class:`~repro_torch.core.export.ServingModel` — loading the
ChainState, exporting through the family's registered serving backend
(``calibrate`` selects the int8-resident plan the scheduler's
bit-exactness contract wants), and keeping it addressable by name so the
launcher/scheduler can route requests.

It is also the failover authority: :meth:`restore` re-exports a named
model from the SAME persisted chain checkpoint its original ``load`` used
— the replica pool (serving/replica.py) calls it when a replica dies
mid-batch, and because export is deterministic from the ChainState the
replacement replica's answers are bit-exact with the dead one's.
"""
from __future__ import annotations

from repro_torch.checkpoint.chain_io import load_chain_state
from repro_torch.core.export import export_chain


class ModelRegistry:
    """Name -> ServingModel map with checkpoint-backed loading."""

    def __init__(self):
        self._models = {}
        self._sources = {}        # name -> (ckpt_dir, family, load kwargs)

    def register(self, name: str, model) -> None:
        """Register an already-exported ServingModel under ``name``."""
        if name in self._models:
            raise ValueError(f'model {name!r} already registered')
        self._models[name] = model

    def load(self, name: str, ckpt_dir: str, family, *, step=None,
             device='cuda', calibrate=None):
        """Load a persisted ChainState (its params on ``family.device``)
        and export it for serving on ``device``.

        ``calibrate`` (a sample batch) compiles the int8-resident layer
        plan — required for the scheduler's bit-exact compaction; the
        chain's stored ``exit_threshold`` rides along via export_chain.
        The checkpoint source is remembered so :meth:`restore` can
        re-export the model after a replica failure.  Returns the
        registered ServingModel.
        """
        state, _ = load_chain_state(ckpt_dir, family, step=step)
        model = export_chain(state, device=device, calibrate=calibrate)
        self.register(name, model)
        self._sources[name] = (ckpt_dir, family,
                               dict(step=step, device=device,
                                    calibrate=calibrate))
        return model

    def restore(self, name: str):
        """Failover: re-export ``name`` from its persisted chain
        checkpoint (the dir its ``load`` read).  Returns a FRESH
        ServingModel — bit-exact with the original because the export is
        deterministic from the ChainState — and re-points the registry
        entry at it.  Raises KeyError for models registered directly
        (no checkpoint to restore from)."""
        if name not in self._sources:
            raise KeyError(
                f'model {name!r} has no checkpoint source (registered '
                f'directly, not loaded); failover needs a load()ed model')
        ckpt_dir, family, kw = self._sources[name]
        state, _ = load_chain_state(ckpt_dir, family, step=kw['step'])
        model = export_chain(state, device=kw['device'],
                             calibrate=kw['calibrate'])
        self._models[name] = model
        return model

    # ------------------------------------------------ multi-model placement

    def plan_placement(self, n_devices: int, stage_costs: dict, *,
                       seed: int = 0):
        """Pack every registered model's stages onto ``n_devices``.

        ``stage_costs`` maps model name -> measured per-stage batch costs
        (each model at its own slot geometry — the cost IS the geometry's
        price), covering every registered name.  Returns the greedy-LPT
        :class:`~repro_torch.serving.placement.Placement` over all N chains:
        ``placement.device_of(stage, model=name)`` answers per model, and
        ``placement.summary()`` reports the achieved per-device loads
        against the LPT load-balance bound.
        """
        from repro_torch.serving.placement import solve_placement
        if not self._models:
            raise ValueError('no models registered to place')
        missing = [n for n in self.names() if n not in stage_costs]
        if missing:
            raise ValueError(f'stage_costs missing for registered '
                             f'model(s) {missing}')
        for name in self.names():
            n_stages = self._models[name].n_stages
            if len(stage_costs[name]) != n_stages:
                raise ValueError(
                    f'model {name!r}: {len(stage_costs[name])} stage '
                    f'costs for {n_stages} stages')
        return solve_placement(
            {name: stage_costs[name] for name in self.names()},
            n_devices, seed=seed)

    def place(self, name: str, placement, devices):
        """Apply a solved placement to a registered model: re-points the
        entry at ``model.place_stages(...)`` with stage *k* pinned to
        ``devices[placement.device_of(k, model=name)]``, and returns the
        placed model.  ``devices`` is the ordinal -> torch device list the
        placement was solved over."""
        model = self.get(name)
        placed = model.place_stages(tuple(
            devices[placement.device_of(k, model=name)]
            for k in range(model.n_stages)))
        self._models[name] = placed
        return placed

    def get(self, name: str):
        if name not in self._models:
            raise KeyError(f'no serving model {name!r} '
                           f'(registered: {sorted(self._models)})')
        return self._models[name]

    def names(self) -> list:
        return sorted(self._models)

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def __len__(self) -> int:
        return len(self._models)
