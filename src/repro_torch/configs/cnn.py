"""Paper-native CNN family configs (ResNet-CIFAR / VGG / MobileNetV2-style).

The paper's own experiments run on ResNet34 / VGG19 / MobileNetV2 over
CIFAR-style 32x32 inputs.  We keep the same family structure at scalable
width/depth so the full chain (D->P->Q->E) reproduces on CPU in minutes.
A copy of the reference's configs, so both packages name the same models.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class CNNConfig:
    name: str
    kind: str                 # resnet | vgg | mobilenet
    num_classes: int = 10
    in_channels: int = 3
    # resnet: blocks per stage; vgg: convs per stage; mobilenet: inverted residuals per stage
    stage_blocks: tuple = (2, 2, 2)
    stage_widths: tuple = (16, 32, 64)
    expand_ratio: int = 4     # mobilenet inverted-bottleneck expansion
    # compression hooks
    w_bits: int = 0
    a_bits: int = 0
    exit_stages: tuple = ()   # stages after which an early-exit head sits

    def replace(self, **kw) -> 'CNNConfig':
        return replace(self, **kw)


RESNET34_CIFAR = CNNConfig(
    name='resnet34-cifar', kind='resnet',
    stage_blocks=(3, 4, 6, 3), stage_widths=(64, 128, 256, 512))

RESNET8_CIFAR = CNNConfig(     # CPU-scale stand-in used by the repro benchmarks
    name='resnet8-cifar', kind='resnet',
    stage_blocks=(1, 1, 1), stage_widths=(16, 32, 64))

VGG19_CIFAR = CNNConfig(
    name='vgg19-cifar', kind='vgg',
    stage_blocks=(2, 2, 4, 4, 4), stage_widths=(64, 128, 256, 512, 512))

VGG8_CIFAR = CNNConfig(
    name='vgg8-cifar', kind='vgg',
    stage_blocks=(1, 1, 2), stage_widths=(16, 32, 64))

MOBILENETV2_CIFAR = CNNConfig(
    name='mobilenetv2-cifar', kind='mobilenet',
    stage_blocks=(1, 2, 3, 2), stage_widths=(16, 24, 32, 64), expand_ratio=6)

MOBILENET_SMALL_CIFAR = CNNConfig(
    name='mobilenet-small-cifar', kind='mobilenet',
    stage_blocks=(1, 1, 1), stage_widths=(8, 16, 32), expand_ratio=4)

CNN_REGISTRY = {c.name: c for c in [
    RESNET34_CIFAR, RESNET8_CIFAR, VGG19_CIFAR, VGG8_CIFAR,
    MOBILENETV2_CIFAR, MOBILENET_SMALL_CIFAR]}
