"""Compression passes as building blocks (the paper's Fig. 1): the trainer,
the chain state and the Q pass of the reference's ``core/passes.py``.

A pass declares static metadata (kind: static/dynamic, granularity:
architecture/neuron/sub-neuron), a typed hyperparameter dataclass and a
transform ``fn(state, hp, trainer) -> state``, packaged as a
:class:`repro_torch.core.registry.CompressionPass` and registered when
this module is imported.  Fine-tuning after a pass uses 1/10 of the
initial LR, as the paper's protocol does.  Ported so far: Q (QAT
fine-tuning).  D, P and E, their hyperparameter classes and the
``PASSES`` view wait for ROADMAP queue A (the chain).

Where the port departs from the reference:

* The training step runs eagerly (the reference jits it):
  :meth:`Trainer.train_step` takes one given batch, so a test can feed the
  same batch to both packages.  It and :meth:`Trainer.evaluate` (the
  reference jits ``family.accuracy``'s forward) compute their QAT scales
  with the jitted arithmetic (``quantization.jitted_scales``).
* Random streams are the port's own.  ``ChainState.key`` is an integer
  seed; :func:`fold_in` derives the next one, as ``jax.random.fold_in``
  does for a key.  :meth:`Trainer.fit` draws batch ``i`` from a CPU
  ``torch.Generator`` seeded ``fold_in(seed, i)``, so its batch stream
  differs from the reference's key stream: the tests share batches, not
  seeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.quantization import jitted_scales
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_map


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from ``seed`` and ``data`` (the port's
    ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1)[0])


# ------------------------------------------------------------------ trainer


def mask_like(params, select: Callable[[str], bool]):
    """0/1 mask tree: 1 where the top-level key satisfies ``select``."""
    return {k: tree_map(lambda x: torch.full((), float(select(k)),
                                             dtype=x.dtype, device=x.device),
                        v) for k, v in params.items()}


def value_and_grad(loss_fn, cfg, params, batch):
    """(loss, grads) of ``loss_fn(params, cfg, batch)``: grads in params'
    tree and dtypes.  Autograd runs on leaves that share params' storage,
    so a stacked ``(G, ...)`` leaf gathers the gradients of every view
    ``leaf[g]`` the layers take of it."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, _ = loss_fn(leaves, cfg, batch)
        loss.backward()
    grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, leaves)
    return loss.detach(), grads


@dataclass
class Trainer:
    batch: int = 64
    steps: int = 300
    lr: float = 1e-3
    eval_n: int = 4
    eval_batch: int = 256
    weight_decay: float = 1e-4
    seed: int = 0

    def optimizer(self, lr=None):
        return adamw(self.lr if lr is None else lr,
                     weight_decay=self.weight_decay)

    def train_step(self, opt, loss_fn, cfg, params, opt_state, batch,
                   mask=None):
        """One AdamW step on ``batch``: the reference's jitted ``step``
        (grads clipped to global norm 1, masked, applied).  Returns (params,
        opt_state, loss); ``opt_state``'s moments are updated in place.
        The QAT scales take the jitted step's ``* recip32(qmax)``."""
        with jitted_scales():
            loss, grads = value_and_grad(loss_fn, cfg, params, batch)
        grads, _ = clip_by_global_norm(grads, 1.0)
        if mask is not None:
            grads = tree_map(lambda g, m: g * m, grads, mask)
        updates, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    def fit(self, family, cfg, params, *, loss_fn=None, lr=None, steps=None,
            train_keys=None, seed=None):
        """AdamW loop; ``train_keys`` restricts training to those top-level
        keys.  Returns (params, the last step's loss or None)."""
        loss_fn = loss_fn or family.loss
        steps = self.steps if steps is None else steps
        opt = self.optimizer(lr)
        opt_state = opt.init(params)
        mask = None
        if train_keys is not None:
            mask = mask_like(params, lambda k: k in train_keys)
        seed = self.seed if seed is None else seed
        last = None
        for i in range(steps):
            batch = family.train_batch(
                torch.Generator().manual_seed(fold_in(seed, i)), self.batch)
            params, opt_state, last = self.train_step(
                opt, loss_fn, cfg, params, opt_state, batch, mask)
        return params, float(last) if last is not None else None

    def evaluate(self, family, cfg, params):
        """``family.accuracy`` on the held-out batches; its QAT scales take
        the jitted forward's ``* recip32(qmax)``, as the reference's do."""
        batches = family.eval_batches(self.eval_n, self.eval_batch)
        with jitted_scales():
            return family.accuracy(params, cfg, batches)


# -------------------------------------------------------------- chain state


@dataclass
class ChainState:
    family: Any
    cfg: Any
    params: Any
    key: int                       # the seed the next pass derives from
    base_bitops: float = 0.0
    base_bits: float = 0.0
    prune_scale: float = 1.0       # stage-MAC multiplier from pruning
    lowrank_scale: float = 1.0     # stage-MAC multiplier from factorization
    exit_probs: dict | None = None
    exit_threshold: float | None = None   # E's operating point, reused by Q
    dyn_accuracy: float | None = None
    history: list = field(default_factory=list)

    @property
    def mac_scale(self) -> float:
        """Combined stage-MAC multiplier for the BitOps cost model."""
        return self.prune_scale * self.lowrank_scale

    def metrics(self, trainer, label):
        acc = (self.dyn_accuracy if self.dyn_accuracy is not None
               else trainer.evaluate(self.family, self.cfg, self.params))
        bops = self.family.bitops(self.cfg, self.exit_probs, self.mac_scale)
        bits = self.family.storage_bits(self.params, self.cfg)
        rec = {'pass': label, 'acc': acc,
               'BitOpsCR': self.base_bitops / max(bops, 1),
               'CR': self.base_bits / max(bits, 1)}
        self.history.append(rec)
        return rec


def init_chain_state(family, cfg, key: int, trainer, *, pretrain_steps=None):
    """Train the original model, the paper's baseline: weights drawn from a
    generator on ``family.device`` seeded ``key``."""
    gen = torch.Generator(device=family.device).manual_seed(key)
    params = family.init(gen, cfg)
    params, _ = trainer.fit(family, cfg, params, steps=pretrain_steps)
    st = ChainState(family=family, cfg=cfg, params=params,
                    key=fold_in(key, 777))
    st.base_bitops = family.bitops(cfg)
    st.base_bits = family.storage_bits(params, cfg)
    st.metrics(trainer, 'baseline')
    return st


# --------------------------------------------------- typed hyperparameters


@dataclass(frozen=True)
class QuantHP:
    w_bits: int = 8
    a_bits: int = 8


# ------------------------------------------------------------------- passes


def _quantize(state: ChainState, hp: QuantHP, trainer: Trainer) -> ChainState:
    if state.exit_probs is not None:
        # the reference re-measures the exit statistics under quantized
        # compute here (family.exit_stats), which is not ported
        raise NotImplementedError('Q after E needs the family\'s '
                                  'exit_stats, not ported yet (ROADMAP, '
                                  'queue A: the chain)')
    cfg = state.cfg.replace(w_bits=hp.w_bits, a_bits=hp.a_bits)
    params, _ = trainer.fit(state.family, cfg, state.params,
                            lr=trainer.lr / 10)
    return replace(state, cfg=cfg, params=params, key=fold_in(state.key, 4))


# -------------------------------------------------------------- registration


registry.register(registry.CompressionPass(
    'Q', 'quantization', 'static', 'sub-neuron', QuantHP, _quantize))

