"""Tests of the port that need a CUDA card: each kernel bit for bit against
its plain version at main-path shapes, and the scheduler on the card
launching the kernels exactly as the plan counts them.

This file imports no JAX, so it also runs on a machine with a card and
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test is marked ``gpu`` and skips through the ``cuda_device`` fixture
when there is no card (decided when the test runs, never at import).
"""
import pytest
import torch

from repro_torch.configs.cnn import RESNET8_CIFAR
from repro_torch.core.export import export_cnn
from repro_torch.core.family import CNNFamily
from repro_torch.data import SyntheticImages
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.fake_quant import fake_quant_fused, fake_quant_plain
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain
from repro_torch.serving import ContinuousBatchScheduler, Request

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    """A CUDA device, or skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize('mkn', [(37, 27, 13), (32768, 27, 64),
                                 (512, 4608, 512), (32, 512, 10)])
def test_quant_matmul_kernel_bit_exact(cuda_device, mkn):
    m, k, n = mkn
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randint(-128, 128, (m, k), generator=g, device=cuda_device,
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=cuda_device,
                      dtype=torch.int32).to(torch.int8)
    sx = torch.rand(m, generator=g, device=cuda_device) * 1e-2
    sw = torch.rand(n, generator=g, device=cuda_device) * 1e-2
    b = torch.randn(n, generator=g, device=cuda_device)
    for kw in (dict(), dict(relu=True, out_scale=0.37)):
        reset_counts()
        got = quant_matmul(x, w, sx, sw, b, **kw)
        assert counts()['quant_matmul'] == {'launches': 1, 'plain_calls': 0}
        want = quant_matmul_plain(x, w, sx, sw, b, **kw)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize('kn', [(128, 10), (512, 10), (1000, 77)])
def test_fake_quant_kernel_bit_exact(cuda_device, kn):
    w = torch.randn(kn, device=cuda_device)
    for bits in (2, 4, 8):
        got = fake_quant_fused(w, bits=bits)
        assert torch.equal(_bits(got), _bits(fake_quant_plain(w, bits=bits)))


def test_quant_matmul_rejects_bad_operands(cuda_device):
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda_device)
    w = torch.zeros((8, 3), dtype=torch.int8, device=cuda_device)
    ones = torch.ones(4, device=cuda_device)
    with pytest.raises(ValueError):
        quant_matmul(x, w, ones, torch.ones(5, device=cuda_device))
    with pytest.raises(ValueError):
        quant_matmul(x.float(), w, ones, torch.ones(3, device=cuda_device))


def test_scheduler_on_card_launches_the_plan(cuda_device):
    fam = CNNFamily(SyntheticImages(), device='cuda')
    params = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                RESNET8_CIFAR,
                                fam.default_exit_points(RESNET8_CIFAR))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    xs = fam.eval_batches(1, 8)[0][0]
    reset_counts()
    model = export_cnn(params, cfg, device=cuda_device, calibrate=xs)
    assert counts()['fake_quant_fused']['launches'] == 3   # exits + head
    reset_counts()
    completions, metrics = ContinuousBatchScheduler(
        model, slots=8, threshold=2.0).run_trace(
            [Request(i, xs[i], 1e-4 * i) for i in range(8)])
    assert len(completions) == 8
    assert counts()['quant_matmul'] == {
        'launches': sum(model.segment_launches[k]
                        for k, _, _ in metrics.batches),
        'plain_calls': 0}
