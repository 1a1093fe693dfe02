"""First-class compression-pass registry (a copy of the reference's
``core/registry.py``; pure Python).

The paper's insertion theorem (Sec. 2) says adding a compression between two
others preserves their pairwise order, so the framework must not hardwire a
closed set of passes.  This module makes passes registrable data:

* :class:`CompressionPass` — key + (kind, granularity) metadata (the two
  axes the paper's sequence law is stated in), a *typed* hyperparameter
  dataclass, and the transform ``fn(state, hp, trainer) -> state``.
* a process-global registry: :func:`register` / :func:`unregister` /
  :func:`get_pass` / :func:`registered_keys`.  ``core/passes.py``
  registers D, P, Q and E and ``core/lowrank.py`` registers L when they
  are imported (importing any ``repro_torch.core`` module imports both).

Ordering: a pass ranks by ``(kind, granularity)`` — static before dynamic,
large granularity before small (the paper's principle).  Two passes in the
same class (e.g. low-rank 'L' and quantization 'Q', both static/sub-neuron)
are outside the theory; ties break deterministically by key.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

# Rank tables for the paper's two ordering axes; check_consistency()
# enforces that every registered pass uses known values.
KIND_RANK = {'static': 0, 'dynamic': 1}
GRANULARITY_RANK = {'architecture': 0, 'neuron': 1, 'sub-neuron': 2}


@dataclass(frozen=True)
class CompressionPass:
    """A registrable compression pass: metadata + typed hps + transform."""
    key: str             # single uppercase letter, e.g. 'Q'
    name: str            # human-readable, e.g. 'quantization'
    kind: str            # static | dynamic
    granularity: str     # architecture | neuron | sub-neuron
    hp_cls: type         # hyperparameter dataclass (typed, with defaults)
    fn: Callable         # (state, hp: hp_cls, trainer) -> state

    @property
    def rank(self) -> tuple:
        """Sort key of the sequence law: static→dynamic, large→small
        granularity; same-class ties break by key (deterministic)."""
        return (KIND_RANK[self.kind], GRANULARITY_RANK[self.granularity],
                self.key)

    def resolve_hp(self, hp: Any = None):
        """Coerce ``hp`` (None | dict | hp_cls) to the typed dataclass.

        Unknown dict keys raise — a typo like ``{'w_bit': 4}`` must not be
        silently ignored (it used to be, with untyped ``hp.get`` dicts).
        """
        if hp is None:
            return self.hp_cls()
        if isinstance(hp, self.hp_cls):
            return hp
        if isinstance(hp, dict):
            known = {f.name for f in dataclasses.fields(self.hp_cls)}
            unknown = sorted(set(hp) - known)
            if unknown:
                raise TypeError(
                    f'pass {self.key!r} ({self.hp_cls.__name__}) got unknown '
                    f'hyperparameters {unknown}; known: {sorted(known)}')
            return self.hp_cls(**hp)
        raise TypeError(f'pass {self.key!r} hyperparameters must be None, '
                        f'dict, or {self.hp_cls.__name__}; got {type(hp)}')

    def apply(self, state, hp, trainer):
        """Resolve hps and run the transform (dict hps are coerced)."""
        return self.fn(state, self.resolve_hp(hp), trainer)


# ----------------------------------------------------------------- registry


_REGISTRY: dict[str, CompressionPass] = {}


def register(pass_: CompressionPass, *, replace: bool = False
             ) -> CompressionPass:
    """Register a pass under its key.  Raises on key collisions unless
    ``replace=True`` (a third-party pass must not shadow silently)."""
    key = pass_.key
    if not (isinstance(key, str) and len(key) == 1 and key.isalpha()
            and key.isupper()):
        raise ValueError(f'pass key must be a single uppercase letter, '
                         f'got {key!r}')
    if key in _REGISTRY and not replace:
        raise ValueError(f'pass key {key!r} already registered '
                         f'({_REGISTRY[key].name}); use replace=True')
    _check_one(pass_)
    _REGISTRY[key] = pass_
    return pass_


def unregister(key: str) -> CompressionPass:
    """Remove and return a registered pass (tests use this to round-trip)."""
    try:
        return _REGISTRY.pop(key)
    except KeyError:
        raise KeyError(f'pass {key!r} is not registered '
                       f'(have {registered_keys()})') from None


def get_pass(key: str) -> CompressionPass:
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(f'unknown pass {key!r} '
                       f'(registered: {registered_keys()})') from None


def registered_keys() -> tuple:
    """All registered pass keys, sorted alphabetically."""
    return tuple(sorted(_REGISTRY))


def registered() -> dict:
    """Snapshot {key: CompressionPass} of the current registry."""
    return dict(_REGISTRY)


# -------------------------------------------------------------- consistency


def _check_one(p: CompressionPass) -> None:
    if p.kind not in KIND_RANK:
        raise ValueError(f'pass {p.key!r}: unknown kind {p.kind!r} '
                         f'(planner ranks: {sorted(KIND_RANK)})')
    if p.granularity not in GRANULARITY_RANK:
        raise ValueError(f'pass {p.key!r}: unknown granularity '
                         f'{p.granularity!r} '
                         f'(planner ranks: {sorted(GRANULARITY_RANK)})')
    if not dataclasses.is_dataclass(p.hp_cls):
        raise ValueError(f'pass {p.key!r}: hp_cls must be a dataclass, '
                         f'got {p.hp_cls!r}')
    # every hp must have a default: Pipeline instantiates hp_cls() when no
    # hps are given for the pass
    for f in dataclasses.fields(p.hp_cls):
        if (f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING):
            raise ValueError(f'pass {p.key!r}: hp field {f.name!r} '
                             f'needs a default value')
    if not callable(p.fn):
        raise ValueError(f'pass {p.key!r}: fn must be callable')


def check_consistency() -> tuple:
    """Validate every registered pass against the planner's rank tables.

    A registered pass with metadata the planner cannot rank would silently
    break the sequence law's ordering.  Returns the checked keys.
    """
    for p in _REGISTRY.values():
        _check_one(p)
    return registered_keys()
