"""The QAT scale against the reference, jitted and eager.

The reference jits its training step, where XLA folds the scale's
``/ qmax`` into ``* fp32(1/qmax)``; its export calibration and
``quantize_params_for_serving`` run eagerly and divide.  The port's
training step computes its scales inside ``quantization.jitted_scales``
and multiplies by ``recip32(qmax)``; everywhere else it divides.  Both
sides are held bit for bit: scales, fake-quantized weights and fake-
quantized activations, on (64, 96) weights and (32, 64) activations from a
seed, at bits 8, 4 and 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import passes as tpasses
from repro_torch.core import quantization as tq
from repro_torch.core.export import _compile_layer_plan
from repro_torch.optim import adamw

torch.set_num_threads(1)

BITS = (8, 4, 2)


def _inputs(bits):
    rng = np.random.default_rng(100 + bits)
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    x = (rng.standard_normal((32, 64)) * 3.0).astype(np.float32)
    return w, x


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _jitted(bits):
    qw = jax.jit(lambda w: jq.quantize_weight(w, bits, axis=-1))
    fw = jax.jit(lambda w: jq.fake_quant_weight(w, bits, axis=-1))
    fa = jax.jit(lambda x: jq.fake_quant_act(x, bits))
    return qw, fw, fa


def _train_step_forward(w, x, bits):
    """The fake-quantized weight and activation that one
    ``Trainer.train_step`` computes in its forward pass, recorded by the
    loss function."""
    seen = {}

    def loss_fn(params, cfg, batch):
        seen['w'] = tq.fake_quant_weight(params['w'], bits).detach().clone()
        seen['x'] = tq.fake_quant_act(batch, bits).detach().clone()
        return (seen['x'] @ tq.fake_quant_weight(params['w'], bits)).sum(), \
            None

    params = {'w': torch.from_numpy(w.copy())}
    opt = adamw(1e-3)
    tpasses.Trainer().train_step(opt, loss_fn, None, params,
                                 opt.init(params), torch.from_numpy(x))
    return seen['w'], seen['x']


@pytest.mark.parametrize('bits', BITS)
def test_train_step_scales_match_the_jitted_reference(bits):
    """Inside the training step the port's scales, fake-quantized weights
    and activations equal the jitted reference's bit for bit.  At 4 bits
    the eager (dividing) scale differs from them, so the test tells the two
    apart (at 2 bits qmax is 1 and the two agree)."""
    w, x = _inputs(bits)
    qw, fw, fa = _jitted(bits)
    q_want, s_want = qw(jnp.asarray(w))
    with tq.jitted_scales():
        q_got, s_got = tq.quantize_weight(torch.from_numpy(w), bits)
    assert not tq._JITTED[0]
    _same(s_got.numpy(), s_want)
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    w_fq, x_fq = _train_step_forward(w, x, bits)
    assert not tq._JITTED[0]
    _same(w_fq.numpy(), fw(jnp.asarray(w)))
    _same(x_fq.numpy(), fa(jnp.asarray(x)))
    if bits == 4:
        _, s_eager = tq.quantize_weight(torch.from_numpy(w), bits)
        assert (_bits(s_eager.numpy()) != _bits(s_want)).any()


def _eval_batches(bits, n=8):
    """``n`` (32, 64) activation batches from a seed: eight abs-max
    values, so that at 4 bits some of their eager and jitted scales
    differ."""
    rng = np.random.default_rng(200 + bits)
    return [(rng.standard_normal((32, 64)) * 3.0).astype(np.float32)
            for _ in range(n)]


def _evaluate_forward(w, xs, bits):
    """The fake-quantized weight and activations that
    ``Trainer.evaluate``'s accuracy forward computes, recorded by a family
    whose ``accuracy`` runs one fake-quantized product a batch."""
    seen = {'x': []}

    class Family:
        def eval_batches(self, n, batch):
            return [torch.from_numpy(x) for x in xs]

        def accuracy(self, params, cfg, batches):
            seen['w'] = tq.fake_quant_weight(params['w'], bits)
            hit = 0.0
            for x in batches:
                seen['x'].append(tq.fake_quant_act(x, bits))
                hit += float((seen['x'][-1] @ seen['w']).argmax(-1).sum())
            return hit

    tpasses.Trainer().evaluate(Family(), None,
                               {'w': torch.from_numpy(w.copy())})
    return seen['w'], seen['x']


@pytest.mark.parametrize('bits', BITS)
def test_evaluate_scales_match_the_jitted_reference(bits):
    """The reference jits ``family.accuracy``'s forward, so the accuracy
    a chain record reports is computed under the jitted scales: the port's
    ``Trainer.evaluate`` forward gives the jitted reference's fake-quantized
    weights and activations bit for bit.  At 4 bits the eager scale would
    differ on the weights and on some of the activation batches."""
    w, _ = _inputs(bits)
    xs = _eval_batches(bits)
    _, fw, fa = _jitted(bits)
    w_fq, x_fq = _evaluate_forward(w, xs, bits)
    assert not tq._JITTED[0]
    _same(w_fq.numpy(), fw(jnp.asarray(w)))
    for got, x in zip(x_fq, xs):
        _same(got.numpy(), fa(jnp.asarray(x)))
    if bits == 4:
        assert (_bits(tq.fake_quant_weight(torch.from_numpy(w), bits)
                      .numpy()) != _bits(fw(jnp.asarray(w)))).any()
        assert any((_bits(tq.fake_quant_act(torch.from_numpy(x), bits)
                          .numpy()) != _bits(fa(jnp.asarray(x)))).any()
                   for x in xs)


@pytest.mark.parametrize('bits', BITS)
def test_eager_scales_still_match_the_eager_reference(bits):
    """Outside the training step (export calibration, serving export) the
    port divides, as the reference's eager calls do, bit for bit."""
    w, x = _inputs(bits)
    q_want, s_want = jq.quantize_weight(jnp.asarray(w), bits, axis=-1)
    q_got, s_got = tq.quantize_weight(torch.from_numpy(w), bits)
    _same(s_got.numpy(), s_want)
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    _same(tq.fake_quant_weight(torch.from_numpy(w), bits).numpy(),
          jq.fake_quant_weight(jnp.asarray(w), bits))
    _same(tq.fake_quant_act(torch.from_numpy(x), bits).numpy(),
          jq.fake_quant_act(jnp.asarray(x), bits))


def test_export_calibration_divides(monkeypatch):
    """The export's calibration forward runs the eager arithmetic: the
    switch is off at every activation fake quant it makes, and its recorded
    activation scales are plain divisions of the abs-max."""
    import repro_torch.models.cnn as cnn_lib
    from repro_torch.configs.cnn import RESNET8_CIFAR
    cfg = RESNET8_CIFAR.replace(w_bits=4, a_bits=4)
    params = cnn_lib.init_cnn(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    seen = []

    def spy(t, bits, **kw):
        seen.append(tq._JITTED[0])
        return tq.fake_quant_act(t, bits, **kw)

    monkeypatch.setattr(cnn_lib, 'fake_quant_act', spy)
    record = []
    plan = _compile_layer_plan(params, cfg, x, 7.0, record=record)
    assert seen and not any(seen)
    for name, key, v in record:
        want = max(float(torch.abs(v).amax()), 1e-8) / 7.0
        got = plan.glues[name] if key == 'glue' else plan.layers[name][key]
        assert got == want
