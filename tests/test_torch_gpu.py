"""Tests of the port that need a CUDA card: each int8 kernel bit for bit
against its plain version at main-path shapes (quant_matmul and
lowrank_conv on both routes and both weight layouts), both fake-quant
wrappers bit for bit in fp32 and bf16 (the fused one on every kind of
launch plan), the decode-attention kernels within their stated tolerance
(the int8 one with whole blocks of its split masked and with no valid
slot), the scheduler on the card launching the kernels exactly as the
plan counts them, one LM decode step and one Q-pass (QAT) step on the
card against the CPU, the CNN compression chain on the card (its
initial weights, P and L on the card's checkpoints against the CPU, a
checkpoint saved on the card and read on the CPU, ``serve_cnn --steps``),
the LM chain hooks on a full-width cut against the CPU, the fake quant at
the factored LM shapes, the dynamic-scale CNN export against its
plain-version twin, the replica pool under a seeded kill on the card
bit-exact against ``fn_exits``, ``ModelRegistry.restore`` on the card and
a measure-mode export timed by CUDA events.

This file imports no JAX, so it also runs on a machine with a card and
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test is marked ``gpu`` and skips through the ``cuda_device`` fixture
when there is no card (decided when the test runs, never at import).
"""
import contextlib
import math

import pytest
import torch

from repro_torch.configs.cnn import MOBILENET_SMALL_CIFAR, RESNET8_CIFAR
from repro_torch.core.export import export_cnn
from repro_torch.core.family import CNNFamily
from repro_torch.data import SyntheticImages
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_int8, decode_attention_int8_plain,
    decode_attention_plain)
from repro_torch.kernels.depthwise_conv import (depthwise_conv,
                                                depthwise_conv_plain)
from repro_torch.kernels.fake_quant import (fake_quant, fake_quant_fused,
                                            fake_quant_plain,
                                            fake_quant_two_pass_plain)
from repro_torch.kernels.lowrank_conv import lowrank_conv, lowrank_conv_plain
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


@pytest.mark.parametrize('mkn', [(32768, 576, 64), (8192, 1152, 128),
                                 (2048, 2304, 256), (512, 4608, 512),
                                 (300, 4608, 512), (129, 1152, 100),
                                 (1, 64, 10), (7, 24, 96), (37, 27, 13)])
@pytest.mark.parametrize('layout', ['k_major', 'row_major'])
def test_quant_matmul_routes_bit_exact(cuda_device, mkn, layout):
    """resnet34-cifar's stage shapes at 32 slots, M tails, a head, and the
    two K % 16 != 0 shapes (K = 24, the stem's 27): bit for bit against the
    plain version on either layout of w.  K % 16 == 0 takes the TMA +
    wgmma kernel, the rest the mma.sync kernel; a row-major w is relaid
    and counted on either route."""
    from repro_torch.kernels.quant_matmul import qmm_plan
    m, k, n = mkn
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = _i8(g, m, k)
    w = _i8(g, k, n)
    if layout == 'k_major':
        w = w.t().contiguous().t()
    sx = torch.rand(m, generator=g, device=cuda_device) * 1e-2
    sw = torch.rand(n, generator=g, device=cuda_device) * 1e-2
    b = torch.randn(n, generator=g, device=cuda_device)
    route = 'wgmma' if k % 16 == 0 else 'mma_sync'
    for kw in (dict(), dict(relu=True, out_scale=0.37)):
        reset_counts()
        got = quant_matmul(x, w, sx, sw, b, **kw)
        assert quant_matmul.launches_by_route[route] == 1
        assert quant_matmul.weight_relayouts == int(layout == 'row_major')
        want = quant_matmul_plain(x, w, sx, sw, b, **kw)
        assert torch.equal(_bits(got), _bits(want)), (qmm_plan(m, n, k), kw)


def _i8(g, *shape):
    return torch.randint(-128, 128, shape, generator=g, device='cuda',
                         dtype=torch.int32).to(torch.int8)


# (x shape, stride, multiplier, x one byte off 16): mobilenetv2-cifar's seven
# depthwise shapes at 32 slots and its x2 case (the tile route), odd shapes
# and an x one byte off 16-byte alignment (the general route)
DW_GPU_CASES = [((32, 32, 32, 96), 1, 1, False),
                ((32, 32, 32, 96), 2, 1, False),
                ((32, 16, 16, 144), 1, 1, False),
                ((32, 16, 16, 144), 2, 1, False),
                ((32, 8, 8, 192), 1, 1, False), ((32, 8, 8, 192), 2, 1, False),
                ((32, 4, 4, 384), 1, 1, False),
                ((32, 16, 16, 48), 1, 2, False), ((2, 9, 7, 32), 2, 2, False),
                ((3, 7, 9, 5), 2, 1, False), ((2, 8, 8, 6), 1, 2, False),
                ((32, 16, 16, 144), 1, 1, True)]


@pytest.mark.parametrize('geom', DW_GPU_CASES)
def test_depthwise_conv_kernel_bit_exact(cuda_device, geom):
    """Bit for bit against the plain version in int8 and fp32 output, with
    and without ReLU, on the route dw_route picks: the tile route at
    mobilenetv2's shapes (and an odd plane at stride 2 with a multiplier),
    the general route at odd channel counts and a misaligned x."""
    from repro_torch.kernels.depthwise_conv import dw_plan
    shape, stride, mult, misaligned = geom
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n = shape[-1] * mult
    x, w = _i8(g, *shape), _i8(g, 3, 3, 1, n)
    if misaligned:
        buf = _i8(g, x.numel() + 1)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    sw = torch.rand(n, generator=g, device=cuda_device) * 1e-2
    b = torch.randn(n, generator=g, device=cuda_device)
    plan = dw_plan(*shape, n, 3, 3, stride)
    assert plan.route == ('tile' if shape[-1] % 16 == 0 else 'general')
    route = 'general' if misaligned else plan.route
    for kw in (dict(), dict(relu=True), dict(out_scale=0.37),
               dict(relu=True, out_scale=0.37)):
        reset_counts()
        got = depthwise_conv(x, w, 0.05, sw, b, stride=stride, **kw)
        assert counts()['depthwise_conv'] == {'launches': 1,
                                              'plain_calls': 0}
        assert depthwise_conv.launches_by_route[route] == 1, (plan, kw)
        want = depthwise_conv_plain(x, w, 0.05, sw, b, stride=stride, **kw)
        assert torch.equal(_bits(got), _bits(want)), (plan, kw)


# (M, K1, R, N): factored resnet34-cifar's eight fused shapes at 32 slots
# (ranks at energy 0.6), M tails and the rest of lr_plan's plans (RP 32 to
# 128, VN 32 and 64, clusters of 1 to 8, ranks with no K1 tile), and two
# K1 % 16 != 0 shapes for the mma.sync route
LR_GPU_SHAPES = [(32768, 576, 30, 64), (8192, 576, 52, 128),
                 (8192, 1152, 59, 128), (8192, 64, 20, 128),
                 (2048, 1152, 103, 256), (2048, 2304, 118, 256),
                 (2048, 128, 41, 256), (512, 256, 82, 512),
                 (300, 2304, 118, 256), (129, 1152, 64, 100), (1, 64, 2, 10),
                 (4096, 576, 128, 200), (1000, 96, 33, 70),
                 (40000, 144, 96, 48), (77, 27, 5, 13), (77, 72, 30, 40)]


@pytest.mark.parametrize('mkrn', LR_GPU_SHAPES)
@pytest.mark.parametrize('layout', ['k_major', 'row_major'])
def test_lowrank_conv_kernel_bit_exact(cuda_device, mkrn, layout):
    """Every plan lr_plan makes at these shapes and both routes, bit for
    bit against the plain version, u and v K-major as the export stores
    them or row-major (then each is relaid and counted)."""
    from repro_torch.kernels.lowrank_conv import lr_plan
    m, k1, r, n = mkrn
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x, u, v = _i8(g, m, k1), _i8(g, k1, r), _i8(g, r, n)
    if layout == 'k_major':
        u, v = u.t().contiguous().t(), v.t().contiguous().t()
    su = torch.rand(r, generator=g, device=cuda_device) * 1e-3
    sv = torch.rand(n, generator=g, device=cuda_device) * 1e-2
    bu, bv = (torch.randn(r, generator=g, device=cuda_device),
              torch.randn(n, generator=g, device=cuda_device))
    route = 'wgmma' if k1 % 16 == 0 else 'mma_sync'
    for kw in (dict(), dict(relu=True, out_scale=0.37)):
        reset_counts()
        got = lowrank_conv(x, u, v, su, sv, bu, bv, sx=0.05, h_scale=0.9,
                           **kw)
        assert counts()['lowrank_conv'] == {'launches': 1, 'plain_calls': 0}
        assert lowrank_conv.launches_by_route[route] == 1
        assert lowrank_conv.weight_relayouts == \
            2 * int(layout == 'row_major')
        want = lowrank_conv_plain(x, u, v, su, sv, bu, bv, sx=0.05,
                                  h_scale=0.9, **kw)
        assert torch.equal(_bits(got), _bits(want)), (lr_plan(m, k1, r, n),
                                                      kw)


def test_lowrank_conv_misaligned_patches_take_mma_sync(cuda_device):
    """Patches that do not start on 16 bytes leave TMA out: the mma.sync
    route, bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    m, k1, r, n = 300, 576, 30, 64
    buf = _i8(g, m * k1 + 1)
    x = buf[1:].view(m, k1)
    u = _i8(g, r, k1).t()
    v = _i8(g, n, r).t()
    su = torch.rand(r, generator=g, device=cuda_device) * 1e-3
    sv = torch.rand(n, generator=g, device=cuda_device) * 1e-2
    bu, bv = (torch.randn(r, generator=g, device=cuda_device),
              torch.randn(n, generator=g, device=cuda_device))
    reset_counts()
    got = lowrank_conv(x, u, v, su, sv, bu, bv, sx=0.05, h_scale=0.9,
                       relu=True, out_scale=0.37)
    assert lowrank_conv.launches_by_route == {'wgmma': 0, 'mma_sync': 1}
    assert lowrank_conv.weight_relayouts == 0
    want = lowrank_conv_plain(x, u, v, su, sv, bu, bv, sx=0.05, h_scale=0.9,
                              relu=True, out_scale=0.37)
    assert torch.equal(got, want)


@pytest.mark.parametrize('kn', [(128, 10), (512, 10), (1000, 77), (40, 13),
                                (2048, 5632), (2048, 2048), (2048, 256),
                                (100000, 10), (8192, 100)])
def test_fake_quant_kernel_bit_exact(cuda_device, kn):
    """fp32 on every kind of launch plan of the cluster kernel: heads and
    ragged shapes (element loads), tinyllama's Q-pass weights (16-byte
    rows, many blocks), a tall head whose slices fit no shared memory
    (walked twice from device memory) and a tall narrow weight on
    clusters of 16; one launch each."""
    w = torch.randn(kn, device=cuda_device)
    for bits in (2, 4, 8):
        reset_counts()
        got = fake_quant_fused(w, bits=bits)
        assert counts()['fake_quant_fused'] == {'launches': 1,
                                                'plain_calls': 0}
        assert torch.equal(_bits(got), _bits(fake_quant_plain(w, bits=bits)))


@pytest.mark.parametrize('kn', [(5632, 2048), (5000, 1000), (4160, 256),
                                (300, 130), (7, 3)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_quant_two_pass_kernel_bit_exact(cuda_device, kn, dtype):
    """tinyllama's MLP wo, ragged shapes (no tile divides 5000, 1000, 300,
    130, 7 or 3) and the smallest K the routing sends here; bf16 rounds
    its fp32 result to nearest even in the kernel's store."""
    w = torch.randn(kn, device=cuda_device).to(dtype)
    for bits in (2, 4, 8):
        reset_counts()
        got = fake_quant(w, bits=bits)
        assert counts()['fake_quant'] == {'launches': 1, 'plain_calls': 0}
        assert got.dtype == dtype
        assert torch.equal(_bits(got),
                           _bits(fake_quant_two_pass_plain(w, bits=bits)))


@pytest.mark.parametrize('kn', [(2048, 5632), (2048, 2048), (2048, 256),
                                (1000, 77), (40, 13), (8192, 100),
                                (100000, 10)])
def test_fake_quant_fused_kernel_bf16_bit_exact(cuda_device, kn):
    w = torch.randn(kn, device=cuda_device).to(torch.bfloat16)
    for bits in (2, 4, 8):
        got = fake_quant_fused(w, bits=bits)
        assert got.dtype == torch.bfloat16
        assert torch.equal(_bits(got), _bits(fake_quant_plain(w, bits=bits)))


@pytest.mark.parametrize('kn', [(643, 3942), (2048, 643), (3942, 643),
                                (643, 2048), (1347, 3941)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fake_quant_fused_kernel_at_factored_shapes(cuda_device, kn, dtype):
    """The shapes L leaves in tinyllama's MLPs after P (d 2048, d_ff 3942,
    an odd rank): rows that are not 16-byte aligned take the element-load
    instantiations."""
    from repro_torch.kernels.fake_quant import fused_plan
    w = torch.randn(kn, device=cuda_device).to(dtype)
    for bits in (8, 2):
        reset_counts()
        got = fake_quant_fused(w, bits=bits)
        assert counts()['fake_quant_fused'] == \
            {'launches': 1, 'plain_calls': 0}
        assert got.dtype == dtype
        assert torch.equal(_bits(got),
                           _bits(fake_quant_plain(w, bits=bits))), \
            fused_plan(*kn, w.element_size())


def test_fake_quant_rejects_bad_operands(cuda_device):
    """No fallback: a dtype, rank or layout the kernels do not take
    raises instead of running anything."""
    w = torch.randn((64, 32), device=cuda_device)
    reset_counts()
    for fn in (fake_quant, fake_quant_fused):
        for bad in (w.half(), w[None], w.t(), w.to(torch.int8)):
            with pytest.raises(ValueError, match='expected a contiguous'):
                fn(bad)
    assert all(c == {'launches': 0, 'plain_calls': 0}
               for c in counts().values())


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
        'launches': sum(model.segment_launches[k]['quant_matmul']
                        for k, _, _ in metrics.batches),
        'plain_calls': 0}


@pytest.mark.parametrize('base', [MOBILENET_SMALL_CIFAR, RESNET8_CIFAR],
                         ids=lambda c: c.name)
def test_scheduler_on_card_launches_each_kernel_of_the_plan(cuda_device,
                                                            base):
    """MobileNet serves its depthwise layers on depthwise_conv; factored
    resnet8 (energy 0.6, every rank in the envelope) its factored convs on
    lowrank_conv.  Per kernel, launches equal the plan's."""
    fam = CNNFamily(SyntheticImages(), device='cuda')
    params = fam.init(torch.Generator().manual_seed(0), base)
    cfg = base
    if base.kind == 'resnet':
        params, cfg, _ = fam.factorize(params, cfg, energy=0.6, min_rank=2)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                cfg, fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    xs = fam.eval_batches(1, 8)[0][0]
    model = export_cnn(params, cfg, device=cuda_device, calibrate=xs,
                       select_kernels='fused')
    reset_counts()
    completions, metrics = ContinuousBatchScheduler(
        model, slots=8, threshold=2.0).run_trace(
            [Request(i, xs[i], 1e-4 * i) for i in range(8)])
    assert len(completions) == 8
    want = {}
    for k, _, _ in metrics.batches:
        for name, n in model.segment_launches[k].items():
            want[name] = want.get(name, 0) + n
    got = counts()
    used = 'depthwise_conv' if base.kind == 'mobilenet' else 'lowrank_conv'
    assert want[used] > 0
    for name, c in got.items():
        assert c == {'launches': want.get(name, 0), 'plain_calls': 0}, name


def _decode_inputs(dev, B, H, K, D, S, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, H, D), (B, S, K, D), (B, S, K, D)))
    valid = torch.arange(S, device=dev) < S - 5
    valid[S // 3:S // 3 + 4] = False            # a hole
    return q, k, v, valid


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize('shape', [(8, 32, 4, 64, 584), (1, 32, 4, 64, 37),
                                   (2, 4, 2, 32, 100), (2, 12, 4, 128, 70),
                                   (1, 16, 16, 64, 33), (1, 16, 4, 128, 700),
                                   (8, 32, 4, 64, 2048)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda_device, shape, dtype):
    """A ragged S (no tile divides 584, 37, 100, 70, 33 or 700), a hole in
    the mask, groups 8, 2, 3, 1 and 4, head_dim 128 at 88 slots a block
    (6 warps, the most an fp32 cache takes at head_dim 128), and 2048
    slots: fp32 within 1e-5 x max|plain|, bf16 within 8e-3 (about
    one bf16 ulp), both on the split kernel."""
    q, k, v, valid = _decode_inputs(cuda_device, *shape, dtype)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    reset_counts()
    got = decode_attention(q, k, v, valid)
    assert counts()['decode_attention'] == {'launches': 1, 'plain_calls': 0}
    assert got.dtype == dtype
    assert _rel_err(got, decode_attention_plain(q, k, v, valid)) <= tol
    from repro_torch.models.attention import kv_quantize
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    got = decode_attention_int8(q, kq, vq, ks, vs, valid)
    want = decode_attention_int8_plain(q, kq, vq, ks, vs, valid)
    assert counts()['decode_attention_int8']['launches'] == 1
    assert _rel_err(got, want) <= tol


@pytest.mark.parametrize('shape,valid_len', [
    ((1, 32, 4, 64, 2048), 2048 - 5), ((8, 32, 4, 64, 584), 40),
    ((2, 12, 4, 128, 700), 100), ((8, 32, 4, 64, 584), 0),
    ((1, 16, 16, 64, 33), 0)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_decode_attention_int8_split_matches_plain(cuda_device, shape,
                                                   valid_len, dtype):
    """The split-S kernel at B = 1 over 2048 slots; a valid prefix so short
    that whole blocks of the cluster hold masked slots only; and no valid
    slot at all, where every block reads all its slots and the output is
    the mean of v.  fp32 within 1e-5 x max|plain|, bf16 within 8e-3."""
    from repro_torch.models.attention import kv_quantize
    q, k, v, _ = _decode_inputs(cuda_device, *shape, dtype)
    S = shape[-1]
    valid = torch.arange(S, device=cuda_device) < valid_len
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    reset_counts()
    got = decode_attention_int8(q, kq, vq, ks, vs, valid)
    assert counts()['decode_attention_int8'] == {'launches': 1,
                                                 'plain_calls': 0}
    assert got.dtype == dtype
    want = decode_attention_int8_plain(q, kq, vq, ks, vs, valid)
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    assert _rel_err(got, want) <= tol
    if not valid_len:
        B, H, K, D, _ = shape
        mean = (vq.float() * vs[..., None]).mean(1).repeat_interleave(
            H // K, dim=1)
        assert _rel_err(got, mean) <= tol


def test_decode_attention_rejects_bad_operands(cuda_device):
    """No fallback: a wrong dtype, a non-contiguous cache, a head_dim or a
    mask the kernel does not take raise instead of running anything."""
    q, k, v, valid = _decode_inputs(cuda_device, 2, 8, 2, 64, 40,
                                    torch.bfloat16)
    reset_counts()
    with pytest.raises(ValueError, match='expected contiguous'):
        decode_attention(q, k.float(), v, valid)
    with pytest.raises(ValueError, match='expected contiguous'):
        decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                         v, valid)
    with pytest.raises(ValueError, match='expected contiguous'):
        decode_attention(q, k, v, valid.to(torch.int32))
    with pytest.raises(ValueError, match='head_dim'):
        decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                         v[..., :48].contiguous(), valid)
    with pytest.raises(ValueError):
        decode_attention_int8(q, k, v, k[..., 0].float(), v[..., 0].float(),
                              valid)
    assert counts()['decode_attention'] == {'launches': 0, 'plain_calls': 0}
    assert counts()['decode_attention_int8'] == \
        {'launches': 0, 'plain_calls': 0}


@pytest.mark.parametrize('kv_bits', [0, 8])
def test_lm_decode_step_on_card_matches_cpu(cuda_device, kv_bits):
    """The tinyllama smoke model (fp32): prefill and one decode step on the
    card, through the decode kernel, against the CPU's plain path on the
    same weights; logits within 1e-4 x max|logit|, TF32 off."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.export import to_device
    from repro_torch.launch import serve
    cfg = get_smoke_config('tinyllama-1.1b').replace(kv_cache_bits=kv_bits)
    model, params = serve.build(cfg, cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev, p in ((cuda_device, params),
                       (torch.device('cpu'), to_device(params, 'cpu'))):
            reset_counts()
            with torch.inference_mode():
                _, cache = model.prefill(p, {'tokens': tokens.to(dev)},
                                         max_len=24)
                logits, _ = model.decode_step(
                    p, torch.tensor([3, 9], device=dev), 16, cache)
            out[dev.type] = (logits.cpu(), counts())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    name = 'decode_attention_int8' if kv_bits else 'decode_attention'
    assert out['cuda'][1][name] == {'launches': 2, 'plain_calls': 0}
    assert out['cpu'][1][name] == {'launches': 0, 'plain_calls': 2}
    assert _rel_err(out['cuda'][0], out['cpu'][0]) <= 1e-4


def test_q_pass_step_on_card_matches_cpu(cuda_device):
    """One Q-pass step of a 2-layer fp32 tinyllama whose MLP wo (4224, 256)
    routes to the two-pass pair, on the card (the fake-quant kernels: 12
    fused and 2 two-pass launches a step) and on the CPU (plain tensor
    ops), same params and batch, TF32 off.  At W8A0 the loss of the new
    params on a held-out batch within 1e-4 x |loss| and the new params
    within 2.5 x lr, at most 0.1% of them more than 1e-2 x lr apart
    (AdamW's first step is about +-lr, so a gradient near 0 may flip sign
    between devices).  At W8A8 the activation fake quant flips codes at
    rounding ties between the two devices' matmuls, which moves whole rows
    of gradients, so that step is held to a finite loss and the launch
    counts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import registry
    from repro_torch.core.export import to_device
    from repro_torch.core.family import LMFamily
    from repro_torch.core.passes import ChainState, Trainer
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config('tinyllama-1.1b').replace(d_model=256, d_ff=4224)
    params = tfm.init_lm(torch.Generator(device=cuda_device).manual_seed(0),
                         cfg, cuda_device)
    tr = Trainer(batch=2, steps=1, lr=1e-3)
    lr = tr.lr / 10
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a_bits in (0, 8):
            out = {}
            for dev in ('cpu', 'cuda'):
                fam = LMFamily(SyntheticTokens(cfg.vocab_size), seq=32,
                               device=dev)
                st = ChainState(family=fam, cfg=cfg,
                                params=to_device(params, dev), key=0)
                reset_counts()
                new = registry.get_pass('Q').apply(
                    st, {'w_bits': 8, 'a_bits': a_bits}, tr)
                launched = counts()
                with torch.no_grad():
                    loss, _ = fam.loss(new.params, new.cfg, fam.train_batch(
                        torch.Generator().manual_seed(9), 2))
                out[dev] = (float(loss), to_device(new.params, 'cpu'),
                            launched)
            assert out['cuda'][2]['fake_quant_fused']['launches'] == 12
            assert out['cuda'][2]['fake_quant']['launches'] == 2
            assert all(c == {'launches': 0, 'plain_calls': 0}
                       for c in out['cpu'][2].values())
            assert all(math.isfinite(o[0]) for o in out.values())
            if a_bits:
                continue
            assert abs(out['cuda'][0] - out['cpu'][0]) <= \
                1e-4 * abs(out['cpu'][0])
            near = n = 0
            for a, b in zip(tree_leaves(out['cuda'][1]),
                            tree_leaves(out['cpu'][1])):
                d = (a - b).abs()
                assert float(d.max()) <= 2.5 * lr
                near += int((d > 1e-2 * lr).sum())
                n += d.numel()
            assert near <= 1e-3 * n
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _leaves_of(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _same_tree_bits(a, b):
    la, lb = _leaves_of(a), _leaves_of(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x.detach().cpu()), _bits(y.detach().cpu()))
        for x, y in zip(la, lb))


def test_cnn_chain_init_on_card_draws_the_cpu_weights(cuda_device):
    """``init_chain_state`` on a card family: the weights the CPU family
    draws from the same seed, moved to the card."""
    from repro_torch.core.passes import Trainer, init_chain_state
    tr = Trainer(batch=4, steps=0, eval_n=1, eval_batch=8)
    st = {dev: init_chain_state(CNNFamily(SyntheticImages(), device=dev),
                                RESNET8_CIFAR, 3, tr, pretrain_steps=0)
          for dev in ('cpu', 'cuda')}
    assert all(t.is_cuda for t in _leaves_of(st['cuda'].params))
    assert _same_tree_bits(st['cuda'].params, st['cpu'].params)


def test_resnet8_chain_on_card_p_and_l_match_cpu(cuda_device, tmp_path):
    """A resnet8 DPLQE chain at steps=1 on the card, checkpointed: P of the
    card's checkpoint after D and L of its checkpoint after P are equal on
    the card and on the CPU, bit for bit; the chain's records are finite
    and its E operating point reaches the exported model."""
    from repro_torch.checkpoint import load_chain_state
    from repro_torch.core.chain import Pipeline
    from repro_torch.core.export import export_chain
    from repro_torch.core.passes import Trainer
    hps = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
           'L': {'energy': 0.9, 'min_rank': 4},
           'Q': {'w_bits': 2, 'a_bits': 8}, 'E': {'threshold': 0.85}}
    data = SyntheticImages(difficulty=0.55)
    tr = Trainer(batch=16, steps=1, lr=2e-3, eval_n=1, eval_batch=32)
    reset_counts()
    st = Pipeline.from_sequence('DPLQE', hps).run(
        CNNFamily(data, device='cuda'), RESNET8_CIFAR, tr, pretrain_steps=1,
        checkpoint_dir=str(tmp_path))
    assert counts()['fake_quant_fused']['launches'] > 0
    assert [h['pass'] for h in st.history] == \
        ['baseline', 'D', 'P', 'L', 'Q', 'E']
    assert all(math.isfinite(h['acc']) for h in st.history)
    out = {}
    for dev in ('cpu', 'cuda'):
        fam = CNNFamily(data, device=dev)
        d, _ = load_chain_state(str(tmp_path), fam, 1)
        p, _ = load_chain_state(str(tmp_path), fam, 2)
        out[dev] = (fam.prune(d.params, d.cfg, 0.3),
                    fam.factorize(p.params, p.cfg, energy=0.9, min_rank=4))
    (pg, cg), (fg, _, sg) = out['cuda']
    (pc, cc), (fc, _, sc) = out['cpu']
    assert cg == cc and _same_tree_bits(pg, pc)
    assert sg == sc and _same_tree_bits(fg, fc)
    x = CNNFamily(data, device='cuda').eval_batches(1, 8)[0][0]
    model = export_chain(st, device='cuda', calibrate=x)
    assert model.exit_threshold == 0.85
    assert model.device.type == 'cuda'


def test_checkpoint_saved_on_card_loads_on_cpu(cuda_device, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {'w': torch.randn(5, 3, generator=g, device=cuda_device),
            'h': [torch.randn(4, generator=g, device=cuda_device)
                  .to(torch.bfloat16)]}
    save_checkpoint(str(tmp_path), 1, tree)
    got, _ = load_checkpoint(str(tmp_path), 1, tree)
    assert all(not t.is_cuda for t in _leaves_of(got))
    assert _same_tree_bits(got, tree)


def test_serve_cnn_fine_tunes_and_serves_on_card(cuda_device):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, '-m', 'repro_torch.launch.serve_cnn', '--server',
         '--config', 'resnet8-cifar', '--requests', '16', '--steps', '2',
         '--device', 'cuda'],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, 'src')),
        capture_output=True, text=True, timeout=600, cwd=root)
    assert r.returncode == 0, r.stderr
    assert 'QAT: 2 steps of 64 images' in r.stdout
    assert 'served 16 requests' in r.stdout
    assert '(plain 0)' in r.stdout and 'quant_matmul=0 ' not in r.stdout


@contextlib.contextmanager
def _plain_int8_kernels():
    """The int8 kernels' plain versions in their wrappers' places, in every
    module that calls them (for a comparison on the card only)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_conv as qc
    saved = (ops.quant_matmul, qc.quant_matmul, ops.depthwise_conv)
    ops.quant_matmul = qc.quant_matmul = quant_matmul_plain
    ops.depthwise_conv = depthwise_conv_plain
    try:
        yield
    finally:
        ops.quant_matmul, qc.quant_matmul, ops.depthwise_conv = saved


@pytest.mark.parametrize('kind', ['resnet8', 'mobilenet-small',
                                  'resnet8-factored'])
def test_dynamic_export_on_card_matches_its_plain_twin(cuda_device, kind):
    """``export_cnn(calibrate=None)`` on the card: ``fn_exits`` on the
    kernels bit for bit against the same export with the plain versions
    in the kernels' places; every ``quant_matmul`` weight K-major (no
    relayout), every call with K % 16 == 0 on ``wgmma``; the stage
    segments chained equal ``fn_exits``."""
    from repro_torch.kernels.quant_matmul import qmm_route
    base = MOBILENET_SMALL_CIFAR if kind == 'mobilenet-small' \
        else RESNET8_CIFAR
    fam = CNNFamily(SyntheticImages(), device='cuda')
    params = fam.init(torch.Generator().manual_seed(0), base)
    cfg = base
    if kind == 'resnet8-factored':
        params, cfg, _ = fam.factorize(params, cfg, energy=0.6, min_rank=2)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                cfg, fam.default_exit_points(cfg))
    cfg = cfg.replace(w_bits=8, a_bits=8)
    model = export_cnn(params, cfg, device='cuda')
    assert model.plan is None and model.backend == 'cuda'
    x = fam.eval_batches(1, 32)[0][0]
    ks = []
    real = quant_matmul

    def spy(x_q, w_q, *a, **kw):
        ks.append((x_q.shape[1], qmm_route(x_q, w_q)))
        return real(x_q, w_q, *a, **kw)
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_conv as qc
    reset_counts()
    ops.quant_matmul = qc.quant_matmul = spy
    try:
        lg, exits = model.fn_exits(model.params, x)
    finally:
        ops.quant_matmul = qc.quant_matmul = real
    c = counts()
    assert quant_matmul.weight_relayouts == 0
    assert all(v['plain_calls'] == 0 for v in c.values())
    assert c['quant_matmul']['launches'] == len(ks) > 0
    assert (c['depthwise_conv']['launches'] > 0) == \
        (kind == 'mobilenet-small')
    assert all((k % 16 == 0) == (r == 'wgmma') for k, r in ks)
    with _plain_int8_kernels():
        reset_counts()
        pl, pexits = model.fn_exits(model.params, x)
        assert all(v['launches'] == 0 for v in counts().values())
    assert torch.equal(_bits(lg), _bits(pl))
    assert all(torch.equal(_bits(exits[s]), _bits(pexits[s]))
               for s in exits)
    sl, sexits = model.serve_stages(x)
    assert torch.equal(_bits(sl), _bits(lg))
    assert all(torch.equal(_bits(sexits[s]), _bits(exits[s]))
               for s in exits)


def _exit_confidences(fam, params, cfg, batch):
    """Each exit head's per-token fp32 softmax maximum, on the CPU: what
    ``LMFamily.exit_stats`` compares with its threshold."""
    from repro_torch.core.quantization import full_fp32, jitted_scales
    with torch.no_grad(), jitted_scales(), full_fp32():
        _, exits = fam.exit_logits(params, cfg, batch)
    return {g: torch.softmax(exits[g].float(), -1).amax(-1).reshape(-1)
            .cpu() for g in sorted(exits)}


def _first_exit(conf, threshold):
    """Per token, the first head whose confidence exceeds ``threshold``,
    or -1."""
    stage = torch.full_like(conf[min(conf)], -1, dtype=torch.int64)
    for g in sorted(conf):
        stage = torch.where((stage < 0) & (conf[g] > threshold),
                            torch.full_like(stage, g), stage)
    return stage


def test_lm_hooks_on_card_match_cpu(cuda_device):
    """tinyllama-1.1b at full width, a 2-layer fp32 cut (weights from a
    CUDA generator), TF32 off: P keeps the same channels in the same order
    on the card and on the CPU; L gives the same ranks and ``u @ v``
    within 1e-4 x max (an fp64 Gram eigendecomposition on the card,
    numpy's SVD on the CPU); the exit heads' per-token decisions are equal but for tokens
    whose confidence lies within 1e-4 x the threshold of it (random heads
    over 32000 tokens are about 1e-3 confident)."""
    from repro_torch.configs import get_config
    from repro_torch.core.export import to_device
    from repro_torch.core.family import LMFamily
    from repro_torch.data import SyntheticTokens
    cfg = get_config('tinyllama-1.1b').replace(num_layers=2,
                                               dtype='float32')
    fams = {dev: LMFamily(SyntheticTokens(cfg.vocab_size), seq=64,
                          device=dev) for dev in ('cpu', 'cuda')}
    params = fams['cuda'].init(fams['cuda'].generator(0), cfg)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev, fam in fams.items():
            p = to_device(params, dev)
            pp, pc = fam.prune(p, cfg, 0.3)
            fp, fc, scale = fam.factorize(pp, pc, energy=0.6)
            out[dev] = (pp, pc, fp, scale)
        assert out['cuda'][1] == out['cpu'][1] and \
            out['cuda'][1].d_ff == 3942
        assert _same_tree_bits(out['cuda'][0], out['cpu'][0])
        assert out['cuda'][3] == out['cpu'][3] < 1.0
        for lg, lc in zip(out['cuda'][2]['blocks'], out['cpu'][2]['blocks']):
            for k in ('wi', 'wg', 'wo'):
                g, c = lg['mlp'][k], lc['mlp'][k]
                assert g['u']['w'].shape == c['u']['w'].shape
                assert g['u']['w'].shape[-1] < 1348
                want = c['u']['w'] @ c['v']['w']
                got = (g['u']['w'] @ g['v']['w']).cpu()
                assert float((got - want).abs().max()) <= \
                    1e-4 * float(want.abs().max())
        fp, fc = out['cuda'][2], out['cuda'][1]
        fp, fc = fams['cuda'].add_exits(fams['cuda'].generator(1), fp, fc,
                                        (0, 1))
        batch = fams['cuda'].train_batch(torch.Generator().manual_seed(2), 2)
        conf = {dev: _exit_confidences(fam, to_device(fp, dev), fc,
                                       to_device(batch, dev))
                for dev, fam in fams.items()}
        thr = float(conf['cpu'][0].median())
        near = torch.zeros_like(conf['cpu'][0], dtype=torch.bool)
        for g in conf['cpu']:
            near |= (conf['cpu'][g] - thr).abs() <= 1e-4 * thr
        stage = {dev: _first_exit(c, thr) for dev, c in conf.items()}
        assert not bool(((stage['cuda'] != stage['cpu']) & ~near).any())
        assert 0 < int((stage['cpu'] == 0).sum()) < stage['cpu'].numel()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _resnet8_on_card(tmp_path):
    """resnet8 with exit heads persisted as a chain checkpoint, and its
    registry-loaded int8-resident export on the card: (registry, model,
    calibration batch)."""
    from repro_torch.checkpoint import save_chain_state
    from repro_torch.core.passes import ChainState
    from repro_torch.serving import ModelRegistry
    fam = CNNFamily(SyntheticImages(), device='cuda')
    params = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    params, cfg = fam.add_exits(torch.Generator().manual_seed(1), params,
                                RESNET8_CIFAR,
                                fam.default_exit_points(RESNET8_CIFAR))
    save_chain_state(str(tmp_path), ChainState(
        family=fam, cfg=cfg.replace(w_bits=8, a_bits=8), params=params,
        key=7, exit_threshold=0.5), step=0)
    xs = fam.eval_batches(1, 8)[0][0]
    reg = ModelRegistry()
    model = reg.load('resnet8', str(tmp_path), fam, device='cuda',
                     calibrate=xs)
    return reg, model, xs


def test_registry_restore_on_card_reexports_the_same_model(cuda_device,
                                                           tmp_path):
    reg, model, xs = _resnet8_on_card(tmp_path)
    assert model.backend == 'cuda' and model.exit_threshold == 0.5
    fresh = reg.restore('resnet8')
    assert fresh is not model and reg.get('resnet8') is fresh
    assert fresh.device.type == 'cuda'
    a, b = model.fn_exits(model.params, xs), fresh.fn_exits(fresh.params, xs)
    assert torch.equal(_bits(a[0]), _bits(b[0]))
    for s in a[1]:
        assert torch.equal(_bits(a[1][s]), _bits(b[1][s]))


def test_replica_pool_on_card_survives_a_kill_bit_exact(cuda_device,
                                                        tmp_path):
    """Two replicas on the card, one killed mid-batch and restored through
    the registry: every request completes, bit for bit against the
    monolithic ``fn_exits`` on the request alone at the slot geometry, and
    every segment batch ran on the kernels."""
    import numpy as np
    from repro_torch.core.export import calibrate_exit_threshold
    from repro_torch.serving import (ChaosPlan, ReplicaPoolScheduler,
                                     exit_decisions)
    reg, model, xs = _resnet8_on_card(tmp_path)
    threshold = calibrate_exit_threshold(model, xs)
    costs = [4e-3, 2e-3, 1e-3]
    t = np.cumsum(np.random.default_rng(0).exponential(1 / 4000.0, 24))
    reqs = [Request(i, xs[i % 8], float(t[i])) for i in range(24)]
    reset_counts()
    comp, metrics = ReplicaPoolScheduler(
        model, slots=8, threshold=threshold, stage_costs=costs, replicas=2,
        min_replicas=2, chaos=ChaosPlan(kills=((4e-3, 0),)),
        restore=lambda: reg.restore('resnet8'),
        restore_delay=costs[0]).run_trace(reqs)
    c = counts()['quant_matmul']
    assert c['plain_calls'] == 0 and c['launches'] > 0
    s = metrics.summary()
    assert len(comp) == 24 and s['availability'] == 1.0
    assert s['resilience']['kills'] == 1 and \
        s['resilience']['failovers'] == 1
    for r in reqs:
        xb = torch.cat([r.x[None], torch.zeros((7,) + tuple(r.x.shape),
                                               device=cuda_device)])
        stage, ans = exit_decisions(*model.fn_exits(model.params, xb),
                                    threshold)
        assert comp[r.rid].exit_stage == int(stage[0])
        assert np.array_equal(comp[r.rid].logits.view(np.int32),
                              ans[0].view(np.int32))


def test_measure_mode_on_card_times_both_lowerings(cuda_device):
    """Measure mode on the card: both lowerings launch their kernels and
    each timed launch is a ``kernel.launch`` span whose length is the
    CUDA-event time it records."""
    from repro_torch.obs import Tracer, check_trace
    fam = CNNFamily(SyntheticImages(), device='cuda')
    params = fam.init(torch.Generator().manual_seed(0), RESNET8_CIFAR)
    params, cfg, _ = fam.factorize(params, RESNET8_CIFAR, energy=0.6,
                                   min_rank=2)
    cfg = cfg.replace(w_bits=8, a_bits=8)
    xs = fam.eval_batches(1, 8)[0][0]
    tracer = Tracer()
    reset_counts()
    model = export_cnn(params, cfg, device=cuda_device, calibrate=xs,
                       select_kernels='measure', tracer=tracer)
    c = counts()
    assert c['lowrank_conv']['launches'] > 0 and \
        c['quant_matmul']['launches'] > 0
    assert c['lowrank_conv']['plain_calls'] == 0 and \
        c['quant_matmul']['plain_calls'] == 0
    spans = [s for s in tracer.spans if s.name == 'kernel.launch']
    assert {s.args['variant'] for s in spans} == {'fused', 'chained'}
    assert all(s.args['us'] > 0 and
               s.dur == pytest.approx(s.args['us'] * 1e-6, abs=1e-7)
               for s in spans)
    assert check_trace(tracer) == []
    delta = model.plan.summary()['lowering_cost_delta']
    assert delta and {s.args['layer'] for s in spans} == set(delta)
    assert bool(torch.isfinite(model.serve(xs)).all())
