"""The port's entry points beside the reference's: ``serve_cnn``'s batch
mode (its stream loop, ``serve_batches``, against the reference's loop on
the same weights and images), the four examples run as
``python -m repro_torch.examples.<name> --device cpu``, the LM launcher's
default arch, and ``data.image_batches``/``lm_batches``.  Without a card
every entry point's default ``--device cuda`` exits with
``export.resolve_device``'s error.  About 80 s on the CPU, most of it the
examples' and launchers' subprocesses.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.cnn import RESNET8_CIFAR as J_RESNET8
from repro.core.export import exit_confidence as j_exit_confidence
from repro.core.export import export_cnn as j_export_cnn
from repro_torch.configs.cnn import RESNET8_CIFAR
from repro_torch.core.export import exit_confidence, export_cnn
from repro_torch.core.family import CNNFamily
from repro_torch.data import (SyntheticImages, SyntheticTokens,
                              image_batches, lm_batches)
from repro_torch.interop import from_jax_params, to_numpy
from repro_torch.launch.serve_cnn import serve_batches

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, N_BATCHES, HW = 8, 3, 16
GAP = 1e-3                   # the threshold's distance to every confidence


@pytest.fixture(scope='module')
def exports():
    """(reference export, port export, stream as numpy (x, y) pairs, exit
    stages, threshold): the port's resnet8 init with exit heads, W8A8,
    handed to the reference as numpy; both exported with dynamic scales,
    as the batch mode exports without --resident."""
    fam = CNNFamily(SyntheticImages(), device='cpu')
    tp = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    tp, tcfg = fam.add_exits(torch.Generator().manual_seed(2), tp,
                             RESNET8_CIFAR,
                             fam.default_exit_points(RESNET8_CIFAR))
    tcfg = tcfg.replace(w_bits=8, a_bits=8)
    cfg = J_RESNET8.replace(exit_stages=tcfg.exit_stages, w_bits=8,
                            a_bits=8)
    p = to_numpy(tp)
    rng = np.random.default_rng(5)
    stream = [(rng.standard_normal((BATCH, HW, HW, 3)).astype(np.float32),
               rng.integers(0, 10, BATCH)) for _ in range(N_BATCHES)]
    ref = j_export_cnn(p, cfg)
    port = export_cnn(from_jax_params(p), tcfg, device='cpu')
    conf = []
    for x, _ in stream:
        _, je = ref.fn_exits(ref.params, x)
        _, te = port.fn_exits(port.params, torch.from_numpy(x))
        conf += [np.asarray(j_exit_confidence(e)) for e in je.values()]
        conf += [exit_confidence(e).numpy() for e in te.values()]
    conf = np.sort(np.concatenate(conf))
    lo, hi = 15 * len(conf) // 100, 85 * len(conf) // 100
    i = lo + int(np.argmax(np.diff(conf[lo:hi + 1])))
    thr = float((conf[i] + conf[i + 1]) / 2)
    assert float(np.min(np.abs(conf - thr))) >= GAP
    return ref, port, stream, tcfg.exit_stages, thr


def test_serve_cnn_batch_mode_matches_the_reference_loop(exports):
    """The exit mix and the accuracy of the batch mode's loop equal the
    reference's ``serve_cnn`` loop (``serve_early_exit`` per batch) on the
    same weights, stream and threshold; some images leave early."""
    ref, port, stream, stages, thr = exports
    j_stages = {s: 0 for s in stages}
    j_hit = j_tot = 0
    for x, y in stream:
        pred, stage = ref.serve_early_exit(x, threshold=thr)
        j_hit += int(np.sum(np.asarray(pred) == y))
        j_tot += int(y.size)
        for s in j_stages:
            j_stages[s] += int(np.sum(np.asarray(stage) == s))
    tot, secs, hit, t_stages = serve_batches(
        port, [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in stream],
        thr, stages)
    assert (tot, hit, t_stages) == (j_tot, j_hit, j_stages)
    assert secs > 0 and sum(t_stages.values()) > 0


def _run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'),
               OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, '-m', module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


def test_serve_cnn_batch_mode_cli_on_the_cpu():
    r = _run('repro_torch.launch.serve_cnn', '--device', 'cpu', '--config',
             'resnet8-cifar', '--steps', '0', '--batches', '2', '--batch',
             '16')
    assert r.returncode == 0, r.stderr
    assert 'served 32 images in' in r.stdout and 'plan=dynamic' in r.stdout
    assert 'exit@stage' in r.stdout and 'final head:' in r.stdout
    r = _run('repro_torch.launch.serve_cnn', '--device', 'cpu', '--config',
             'resnet8-cifar', '--steps', '0', '--batches', '1', '--batch',
             '8', '--resident')
    assert r.returncode == 0, r.stderr
    assert 'layer plan:' in r.stdout and 'plan=resident' in r.stdout


@pytest.mark.parametrize('example,args,expect', [
    ('quickstart', ('--smoke',), 'served int8 logits (8, 10)'),
    ('quickstart', ('--serve-cnn',), 'early-exit stages:'),
    ('quickstart', ('--arch', 'gemma2-9b', '--steps', '2'),
     'decoded continuation:'),
    ('chain_cnn', ('--steps', '1'), 'E '),
    ('chain_lm', ('--steps', '1', '--layers', '2'), 'E '),
    ('serve_lm', ('--arch', 'gemma2-9b'), 'ms/token'),
])
def test_examples_run_on_the_cpu(example, args, expect):
    r = _run(f'repro_torch.examples.{example}', *args, '--device', 'cpu')
    assert r.returncode == 0, r.stderr
    assert expect in r.stdout, r.stdout


@pytest.mark.parametrize('module', [
    'repro_torch.examples.quickstart', 'repro_torch.examples.chain_cnn',
    'repro_torch.examples.chain_lm', 'repro_torch.examples.serve_lm',
    'repro_torch.launch.serve_cnn', 'repro_torch.launch.serve',
    'repro_torch.launch.train'])
def test_entry_points_refuse_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    extra = ('--smoke',) if module.endswith('.serve') else ()
    r = _run(module, *extra, '--device', 'cuda')
    assert r.returncode != 0
    assert 'no CUDA device' in r.stderr


def test_lm_launcher_defaults_to_the_reference_arch():
    """``launch/serve.py``'s default arch is the reference's, gemma2-9b;
    an encoder-decoder exits with the reference's message."""
    r = _run('repro_torch.launch.serve', '--smoke', '--device', 'cpu',
             '--tokens', '2', '--batch', '2', '--prompt-len', '8')
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith('gemma2-9b-smoke:')
    r = _run('repro_torch.launch.serve', '--smoke', '--device', 'cpu',
             '--arch', 'internvl2-2b', '--tokens', '2', '--batch', '2',
             '--prompt-len', '8')
    assert r.returncode == 0 and 'internvl2-2b-smoke:' in r.stdout, r.stderr
    r = _run('repro_torch.launch.serve', '--smoke', '--device', 'cpu',
             '--arch', 'whisper-small')
    assert r.returncode != 0
    assert 'decoder-only serving example' in r.stderr


def test_image_batches_and_lm_batches():
    """Deterministic streams: batch i from ``fold_in(seed, i)`` (and the
    host's index folded in for a token stream), the same on every call;
    hosts split a batch."""
    ds = SyntheticImages()
    a = list(image_batches(ds, 4, 3, seed=1))
    b = list(image_batches(ds, 4, 3, seed=1))
    assert len(a) == 3 and a[0][0].shape == (4, 32, 32, 3)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert not torch.equal(a[0][0], a[1][0])
    assert not torch.equal(a[0][0], next(image_batches(ds, 4, 1, seed=2))[0])
    tok = SyntheticTokens(vocab=64)
    h0 = list(lm_batches(tok, 8, 16, 2, host_id=0, num_hosts=2))
    h1 = list(lm_batches(tok, 8, 16, 2, host_id=1, num_hosts=2))
    assert h0[0]['tokens'].shape == (4, 16)
    assert not torch.equal(h0[0]['tokens'], h1[0]['tokens'])
    again = list(lm_batches(tok, 8, 16, 2, host_id=1, num_hosts=2))
    assert all(torch.equal(x['tokens'], y['tokens'])
               for x, y in zip(h1, again))
