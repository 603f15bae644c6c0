"""The paper's own testbeds (Table I/II): AlexNet, ResNet-18, VGG-16 and
LeViT-128S/192/256 at CIFAR-10 / MNIST scale."""
import dataclasses

from repro_torch.models.cnn_zoo import AlexNetConfig, LeViTConfig, VGGConfig
from repro_torch.models.resnet import ResNetConfig

ALEXNET_CIFAR = AlexNetConfig(name="alexnet", img_res=32, in_channels=3,
                              n_classes=10)
ALEXNET_MNIST = AlexNetConfig(name="alexnet-mnist", img_res=28,
                              in_channels=1, n_classes=10,
                              channels=(32, 64, 96, 64, 64),
                              fc_dims=(256, 128))
RESNET18_CIFAR = ResNetConfig(name="resnet-18", depths=(2, 2, 2, 2),
                              width=64, block="basic", img_res=32,
                              n_classes=10, small_input=True)
VGG16_CIFAR = VGGConfig(name="vgg16", img_res=32, n_classes=10)

LEVIT_128S = LeViTConfig(name="levit-128s", img_res=32, n_classes=10,
                         dims=(128, 256, 384), heads=(4, 6, 8),
                         depths=(2, 3, 4), stem_convs=2)
LEVIT_192 = LeViTConfig(name="levit-192", img_res=32, n_classes=10,
                        dims=(192, 288, 384), heads=(3, 5, 6),
                        depths=(4, 4, 4), stem_convs=2)
LEVIT_256 = LeViTConfig(name="levit-256", img_res=32, n_classes=10,
                        dims=(256, 384, 512), heads=(4, 6, 8),
                        depths=(4, 4, 4), stem_convs=2)

# small variant for fast CI
ALEXNET_TINY = dataclasses.replace(ALEXNET_CIFAR,
                                   channels=(16, 32, 48, 32, 32),
                                   fc_dims=(128, 64))
