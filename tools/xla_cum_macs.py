"""XLA's cumulative MACs per exit of a staged classifier of the JAX
package, from shapes alone.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_cum_macs.py \
        vit-s16 vit-h14 convnext-b resnet-152

Prints one JSON line per arch id: the numbers the JAX engine's
``DartEngine.measure_costs((R, R, 3))`` returns (XLA's cost analysis of
each stage and exit head compiled at batch 1, flops halved; the stem
not counted) at the config's ``img_res``.  The parameters and the
activations are ``jax.ShapeDtypeStruct``s, so no weight is drawn or held:
cost analysis reads shapes only, and the engine compiles the same
functions on the same shapes.  ``tests/test_torch_vit.py`` and
``chip_smoke.py`` pin these numbers and hold the port's
``measure_costs`` to them.
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp

from repro.compat import cost_analysis_dict
from repro.configs import registry
from repro.models import get_family
from repro.parallel.sharding import unzip


def xla_cum_macs(cfg) -> list[float]:
    fam = get_family(cfg)
    params = jax.eval_shape(
        lambda: unzip(fam.init(jax.random.key(0), cfg))[0])
    x = jax.ShapeDtypeStruct((1, cfg.img_res, cfg.img_res,
                              cfg.in_channels), jnp.float32)
    h = jax.eval_shape(lambda p, x: fam.apply_stem(p, x, cfg), params, x)

    def flops(fn, *args):
        return float(cost_analysis_dict(
            jax.jit(fn).lower(*args).compile()).get("flops", 0.0))

    cum, total = [], 0.0
    for s in range(fam.num_stages(cfg)):
        def stage(p, h, s=s):
            return fam.apply_stage(p, h, s, cfg)

        def head(p, h, s=s):
            return fam.apply_exit(p, h, s, cfg)
        total += flops(stage, params, h)
        h = jax.eval_shape(stage, params, h)
        cum.append((total + flops(head, params, h)) / 2.0)
    return cum


def main(argv) -> int:
    for arch in argv or list(registry.ASSIGNED):
        cfg = registry.get(arch)
        if not get_family(cfg).staged:
            continue
        print(json.dumps({"arch": arch, "img_res": cfg.img_res,
                          "xla_cum_macs": xla_cum_macs(cfg)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
