"""repro_torch — the PyTorch/CUDA port of the DART reproduction.

A second package beside the JAX reference ``repro``; it imports neither
``jax`` nor ``repro``.  Modules mirror ``repro``'s layout (``core``,
``models``, ``engine``, ``kernels``, ``data``, ``configs``).  Entry
points run on a CUDA device unless the caller passes ``device="cpu"``;
on a CUDA tensor each fused op launches its hand-written kernel
(``csrc/``), on a CPU tensor it runs the plain torch version.

    from repro_torch.configs.paper_testbeds import VGG16_CIFAR
    from repro_torch.engine import DartEngine
    from repro_torch.models import get_family

    params = get_family(VGG16_CIFAR).init(VGG16_CIFAR, seed=0,
                                          device="cuda")
    engine = DartEngine.from_config(VGG16_CIFAR, params)
"""
