"""Compression passes as building blocks (the paper's Fig. 1): the trainer,
the chain state and the passes D, P, Q and E of the reference's
``core/passes.py`` (L is ``core/lowrank.py``).

A pass declares static metadata (kind: static/dynamic, granularity:
architecture/neuron/sub-neuron), a typed hyperparameter dataclass and a
transform ``fn(state, hp, trainer) -> state``, packaged as a
:class:`repro_torch.core.registry.CompressionPass` and registered when
this module is imported.  Fine-tuning after a pass uses 1/10 of the
initial LR, as the paper's protocol does.  ``PASSES`` is a live read-only
view of the registry (the reference's old closed dict API).

Where the port departs from the reference:

* The training step runs eagerly (the reference jits it):
  :meth:`Trainer.train_step` takes one given batch, so a test can feed the
  same batch to both packages.  It and :meth:`Trainer.evaluate` (the
  reference jits ``family.accuracy``'s forward) compute their QAT scales
  with the jitted arithmetic (``quantization.jitted_scales``) and their
  fp32 convs and matmuls without TF32 (``quantization.full_fp32``).
* Random streams are the port's own.  ``ChainState.key`` is an integer
  seed; :func:`fold_in` derives the next one, as ``jax.random.fold_in``
  does for a key.  :meth:`Trainer.fit` draws batch ``i`` from a CPU
  ``torch.Generator`` seeded ``fold_in(seed, i)``, so its batch stream
  differs from the reference's key stream: the tests share batches, not
  seeds.  The seeds each pass derives from ``key``, where the reference
  folds the same data into its key: the baseline's weights ``key`` itself
  and the chain's key ``fold_in(key, 777)``; D's student weights
  ``fold_in(key, 1)`` and its batches ``fold_in(key, 0)`` (the reference
  draws an integer from its key), P, L and Q train on ``Trainer.seed``'s
  batches, as the reference's do, E's heads ``fold_in(key, 5)``; each pass
  leaves ``fold_in(key, n)`` for the next, n = 2 (D), 3 (P), 4 (Q), 6 (E)
  and 7 (L).  Weights come from ``family.generator(seed)``.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field, replace
from typing import Any, Callable

import torch

from repro_torch.core import registry
from repro_torch.core.quantization import full_fp32, jitted_scales
from repro_torch.data.synthetic import fold_in
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_map


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
        The QAT scales take the jitted step's ``* recip32(qmax)``; TF32
        stays off."""
        with jitted_scales(), full_fp32():
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
        with jitted_scales(), full_fp32():
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
    """Train the original model, the paper's baseline: weights drawn from
    ``family.generator(key)``."""
    params = family.init(family.generator(key), cfg)
    params, _ = trainer.fit(family, cfg, params, steps=pretrain_steps)
    st = ChainState(family=family, cfg=cfg, params=params,
                    key=fold_in(key, 777))
    st.base_bitops = family.bitops(cfg)
    st.base_bits = family.storage_bits(params, cfg)
    st.metrics(trainer, 'baseline')
    return st


# --------------------------------------------------- typed hyperparameters


@dataclass(frozen=True)
class DistillHP:
    factor: float = 0.5      # student size factor (depth or width)
    temp: float = 2.0        # KD temperature
    alpha: float = 0.5       # KL weight vs. CE


@dataclass(frozen=True)
class PruneHP:
    ratio: float = 0.3       # fraction of channels removed


@dataclass(frozen=True)
class QuantHP:
    w_bits: int = 8
    a_bits: int = 8


@dataclass(frozen=True)
class EarlyExitHP:
    stages: tuple | None = None    # None = family.default_exit_points
    threshold: float = 0.9         # softmax-confidence exit threshold


# ------------------------------------------------------------------- passes


def kd_loss(fam, t_params, t_cfg, temp, alpha):
    """The distillation loss over a student's params: ``alpha`` x the
    T^2-scaled KL divergence of the student's tempered softmax from the
    teacher's, plus ``1 - alpha`` x the student's cross entropy.  The
    teacher's logits are computed without autograd."""
    def loss(p, cfg, batch):
        ce, s_logits = fam.loss(p, cfg, batch)
        with torch.no_grad():
            t_logits = fam.logits_of(t_params, t_cfg, batch)
        t = t_logits / temp
        kl = torch.mean(torch.sum(
            torch.softmax(t, -1) * (torch.log_softmax(t, -1)
                                    - torch.log_softmax(s_logits / temp, -1)),
            dim=-1)) * temp ** 2
        return alpha * kl + (1 - alpha) * ce, s_logits
    return loss


def _distill(state: ChainState, hp: DistillHP, trainer: Trainer) -> ChainState:
    # T=2, alpha=0.5 defaults: at T=4 the T^2-scaled KL dominates the
    # clipped gradient and stalls student training (the reference measured)
    fam, t_cfg, t_params = state.family, state.cfg, state.params
    s_cfg = fam.shrink(t_cfg, hp.factor)
    s_params = fam.init(fam.generator(fold_in(state.key, 1)), s_cfg)
    # a student is trained from scratch: give it the full (pretrain-scale)
    # budget, like the paper's 200-epoch student training
    s_params, _ = trainer.fit(fam, s_cfg, s_params,
                              loss_fn=kd_loss(fam, t_params, t_cfg, hp.temp,
                                              hp.alpha),
                              steps=trainer.steps * 3,
                              seed=fold_in(state.key, 0))
    return replace(state, cfg=s_cfg, params=s_params,
                   key=fold_in(state.key, 2), exit_probs=None,
                   dyn_accuracy=None, prune_scale=1.0, lowrank_scale=1.0)


def _prune(state: ChainState, hp: PruneHP, trainer: Trainer) -> ChainState:
    fam = state.family
    params, cfg = fam.prune(state.params, state.cfg, hp.ratio)
    params, _ = trainer.fit(fam, cfg, params, lr=trainer.lr / 10)
    scale = state.prune_scale
    if hasattr(fam, 'pruned_bitops_scale'):
        scale *= fam.pruned_bitops_scale(hp.ratio, cfg)
    return replace(state, cfg=cfg, params=params, prune_scale=scale,
                   key=fold_in(state.key, 3), exit_probs=None,
                   dyn_accuracy=None)


def _quantize(state: ChainState, hp: QuantHP, trainer: Trainer) -> ChainState:
    cfg = state.cfg.replace(w_bits=hp.w_bits, a_bits=hp.a_bits)
    params, _ = trainer.fit(state.family, cfg, state.params,
                            lr=trainer.lr / 10)
    new = replace(state, cfg=cfg, params=params, key=fold_in(state.key, 4))
    if new.exit_probs is not None:
        # re-measure the dynamic statistics under quantized compute, at the
        # operating point E established: Q has no threshold of its own
        thr = (state.exit_threshold if state.exit_threshold is not None
               else 0.9)
        acc, probs = state.family.exit_stats(
            params, cfg, state.family.eval_batches(trainer.eval_n,
                                                   trainer.eval_batch), thr)
        new = replace(new, exit_probs=probs, dyn_accuracy=acc)
    return new


def _early_exit(state: ChainState, hp: EarlyExitHP,
                trainer: Trainer) -> ChainState:
    fam = state.family
    stages = hp.stages
    if stages is None:
        stages = fam.default_exit_points(state.cfg)
    params, cfg = fam.add_exits(fam.generator(fold_in(state.key, 5)),
                                state.params, state.cfg, stages)
    # the paper (Sec 3.1.3/3.1.6): exit heads learn from the student's own
    # body; heads only, body frozen, full LR
    exit_key = 'exits' if 'exits' in params else 'exit_heads'
    params, _ = trainer.fit(fam, cfg, params,
                            loss_fn=getattr(fam, 'exit_loss', None),
                            train_keys={exit_key})
    acc, probs = fam.exit_stats(
        params, cfg, fam.eval_batches(trainer.eval_n, trainer.eval_batch),
        hp.threshold)
    return replace(state, cfg=cfg, params=params, exit_probs=probs,
                   exit_threshold=hp.threshold, dyn_accuracy=acc,
                   key=fold_in(state.key, 6))


# -------------------------------------------------------------- registration


registry.register(registry.CompressionPass(
    'D', 'distillation', 'static', 'architecture', DistillHP, _distill))
registry.register(registry.CompressionPass(
    'P', 'pruning', 'static', 'neuron', PruneHP, _prune))
registry.register(registry.CompressionPass(
    'Q', 'quantization', 'static', 'sub-neuron', QuantHP, _quantize))
registry.register(registry.CompressionPass(
    'E', 'early-exit', 'dynamic', 'architecture', EarlyExitHP, _early_exit))


class _RegistryView(Mapping):
    """Read-only mapping view of the live registry (the old ``PASSES``
    API)."""

    def __getitem__(self, key):
        return registry.get_pass(key)

    def __iter__(self):
        return iter(registry.registered_keys())

    def __len__(self):
        return len(registry.registered_keys())


#: Deprecated alias: a live view of ``core.registry``.
PASSES = _RegistryView()
