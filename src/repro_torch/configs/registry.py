"""Architecture registry of the port: the JAX package's
``configs/registry.py`` for the architectures the port has.

``get(arch)``         — the full (assignment-exact) config
``get_reduced(arch)`` — the small config of the same family
``paper_testbeds()``  — the paper's own testbeds by name

An assigned id the port does not have yet raises a ``KeyError`` that
names the ROADMAP item porting it.  The dry-run's ``shapes`` and
``cells`` wait for the multi-device slice (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import importlib

ASSIGNED = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "vit-h14": "repro_torch.configs.vit_h14",
    "convnext-b": "repro_torch.configs.convnext_b",
    "resnet-152": "repro_torch.configs.resnet_152",
    "vit-s16": "repro_torch.configs.vit_s16",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
}

#: assigned ids not ported yet, and the ROADMAP queue 1 item that ports
#: each
NOT_PORTED = {
    "deepseek-v3-671b": "item 6c (MLA and MTP)",
    "dit-s2": "item 8 (dit.py)",
    "dit-xl2": "item 8 (dit.py)",
}


def _module(arch: str):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet: ROADMAP queue 1, "
                       f"{NOT_PORTED[arch]}")
    if arch not in ASSIGNED:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ASSIGNED)}")
    return importlib.import_module(ASSIGNED[arch])


def get(arch: str):
    return _module(arch).CONFIG


def get_reduced(arch: str):
    return _module(arch).REDUCED


def paper_testbeds():
    from repro_torch.configs import paper_testbeds as pt
    return {
        "alexnet": pt.ALEXNET_CIFAR, "alexnet-mnist": pt.ALEXNET_MNIST,
        "resnet-18": pt.RESNET18_CIFAR, "vgg16": pt.VGG16_CIFAR,
        "levit-128s": pt.LEVIT_128S, "levit-192": pt.LEVIT_192,
        "levit-256": pt.LEVIT_256,
    }
