"""Model zoo of the port: uniform access to each architecture family.

``FAMILIES[family]`` exposes ``init(cfg, seed=, device=)``, ``forward``
(all exits) and the stem/stage/exit functions the DART serving engine
drives; ``staged`` says whether a family has them.  The port carries
the paper's AlexNet, VGG, ResNet and LeViT testbeds, the assigned ViT
(ViT-S/16, ViT-H/14), ConvNeXt (ConvNeXt-B) and ResNet-152, and the
dense GQA language models (``lm``: TinyLlama-1.1B, InternLM2-20B), which
the trainer drives and ``engine.lm.LMDecodeEngine`` serves.
"""
from __future__ import annotations

from repro_torch.models import (cnn_zoo, convnext, resnet, transformer_lm,
                                vit)
from repro_torch.models.cnn_zoo import AlexNetConfig, LeViTConfig, VGGConfig
from repro_torch.models.convnext import ConvNeXtConfig
from repro_torch.models.resnet import ResNetConfig
from repro_torch.models.transformer_lm import LMConfig
from repro_torch.models.vit import ViTConfig


class _Family:
    def __init__(self, init, forward, *, stem=None, stage=None, exit_=None,
                 n_stages=None):
        self.init = init
        self.forward = forward
        self.apply_stem = stem
        self.apply_stage = stage
        self.apply_exit = exit_
        self.num_stages = n_stages

    @property
    def staged(self) -> bool:
        return self.apply_stage is not None


FAMILIES = {
    "lm": _Family(transformer_lm.lm_init, transformer_lm.lm_forward),
    "vit": _Family(vit.vit_init, vit.vit_forward, stem=vit.apply_stem,
                   stage=vit.apply_stage, exit_=vit.apply_exit,
                   n_stages=vit.num_stages),
    "convnext": _Family(convnext.convnext_init, convnext.convnext_forward,
                        stem=convnext.apply_stem, stage=convnext.apply_stage,
                        exit_=convnext.apply_exit,
                        n_stages=convnext.num_stages),
    "resnet": _Family(resnet.resnet_init, resnet.resnet_forward,
                      stem=resnet.apply_stem, stage=resnet.apply_stage,
                      exit_=resnet.apply_exit, n_stages=resnet.num_stages),
    "alexnet": _Family(cnn_zoo.alexnet_init, cnn_zoo.alexnet_forward,
                       stem=cnn_zoo.alexnet_apply_stem,
                       stage=cnn_zoo.alexnet_apply_stage,
                       exit_=cnn_zoo.alexnet_apply_exit,
                       n_stages=cnn_zoo.alexnet_num_stages),
    "vgg": _Family(cnn_zoo.vgg_init, cnn_zoo.vgg_forward,
                   stem=cnn_zoo.vgg_apply_stem,
                   stage=cnn_zoo.vgg_apply_stage,
                   exit_=cnn_zoo.vgg_apply_exit,
                   n_stages=cnn_zoo.vgg_num_stages),
    "levit": _Family(cnn_zoo.levit_init, cnn_zoo.levit_forward,
                     stem=cnn_zoo.levit_apply_stem,
                     stage=cnn_zoo.levit_apply_stage,
                     exit_=cnn_zoo.levit_apply_exit,
                     n_stages=cnn_zoo.levit_num_stages),
}


def family_of(cfg) -> str:
    return {LMConfig: "lm", ViTConfig: "vit", ConvNeXtConfig: "convnext",
            ResNetConfig: "resnet", AlexNetConfig: "alexnet",
            VGGConfig: "vgg", LeViTConfig: "levit"}[type(cfg)]


def get_family(cfg) -> _Family:
    return FAMILIES[family_of(cfg)]


__all__ = ["cnn_zoo", "convnext", "resnet", "transformer_lm", "vit",
           "AlexNetConfig", "VGGConfig", "LeViTConfig", "ConvNeXtConfig",
           "ResNetConfig", "LMConfig", "ViTConfig", "FAMILIES", "family_of",
           "get_family"]
