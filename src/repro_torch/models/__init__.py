"""Model zoo of the port: uniform access to each architecture family.

``FAMILIES[family]`` exposes ``init(cfg, seed=, device=)``, ``forward``
(all exits) and the stem/stage/exit functions the DART serving engine
drives.  This slice carries the paper's AlexNet and VGG testbeds.
"""
from __future__ import annotations

from repro_torch.models import cnn_zoo
from repro_torch.models.cnn_zoo import AlexNetConfig, VGGConfig


class _Family:
    def __init__(self, init, forward, *, stem, stage, exit_, n_stages):
        self.init = init
        self.forward = forward
        self.apply_stem = stem
        self.apply_stage = stage
        self.apply_exit = exit_
        self.num_stages = n_stages


FAMILIES = {
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
}


def family_of(cfg) -> str:
    return {AlexNetConfig: "alexnet", VGGConfig: "vgg"}[type(cfg)]


def get_family(cfg) -> _Family:
    return FAMILIES[family_of(cfg)]


__all__ = ["cnn_zoo", "AlexNetConfig", "VGGConfig", "FAMILIES", "family_of",
           "get_family"]
