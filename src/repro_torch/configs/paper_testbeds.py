"""The paper's own testbeds (Table I): AlexNet, ResNet-18 and VGG-16 at
CIFAR-10 / MNIST scale.  The LeViT variants wait for their model."""
import dataclasses

from repro_torch.models.cnn_zoo import AlexNetConfig, VGGConfig
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

# small variant for fast CI
ALEXNET_TINY = dataclasses.replace(ALEXNET_CIFAR,
                                   channels=(16, 32, 48, 32, 32),
                                   fc_dims=(128, 64))
