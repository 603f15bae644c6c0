"""Shared set-up of the serving and obs parity tests: one JAX and one
port ``DartEngine`` per case with the same weights and policy, a fake
scheduler clock, and a seeded burst driven through both servers with
``start=False`` and ``pump()``.

The images come from the synthetic set with a hash-free seed (as in
``test_torch_engine.py``), so every worker and every run sees the same
draw.  The JAX engine compiles its forward once per (bucket, stage)
shape and keeps the compiled functions, so each case builds it once;
``EnginePair.reset`` gives each test the fresh state back."""
import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_testbeds as jTB
from repro.engine import DartEngine as JaxEngine
from repro.serving import AsyncDartServer as JaxServer
from repro.serving import SchedulerConfig as JaxConfig
from repro_torch import convert
from repro_torch.configs import paper_testbeds as TB
from repro_torch.data import datasets as DS
from repro_torch.engine import DartEngine
from repro_torch.models import get_family
from repro_torch.serving import AsyncDartServer, SchedulerConfig

# conf, alpha: fp32 reductions and convolutions in another order (as in
# test_torch_engine.py)
CAL_ATOL = 1e-5
# rows whose conf at a gate lies this close to tau' may route differently
EDGE = 1e-5

CASES = {
    "alexnet-tiny": (jTB.ALEXNET_TINY, TB.ALEXNET_TINY),
    # ResNet-18 (basic blocks 2-2-2-2, four exits) at width 8
    "resnet18-narrow": (dataclasses.replace(jTB.RESNET18_CIFAR, width=8),
                        dataclasses.replace(TB.RESNET18_CIFAR, width=8)),
}
DATA = DS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=1024)
# three buckets: the size flush, min_fill and padding all have a choice,
# and the JAX engine compiles each shape once
BUCKETS = (4, 8, 16)
POOL = (256, 128)          # (offset, size) of the eval images requests use


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _fixed_rng_for(cfg, index, split):
    """``datasets._rng_for`` with a hash-free base per (seed, split)."""
    base = zlib.crc32(f"{cfg.seed}/{split}".encode()) % (2**31 - 1)
    return np.random.RandomState(base ^ (index * 2654435761 % (2**31 - 1)))


def _jax_layout(tree):
    """The port's init in the JAX layout (conv OIHW -> HWIO)."""
    return jax.tree.map(lambda t: t.permute(2, 3, 1, 0).numpy()
                        if t.dim() == 4 else t.numpy(), tree)


@dataclasses.dataclass
class EnginePair:
    jeng: object
    eng: DartEngine
    images: np.ndarray                 # the request pool, NHWC float32
    states: tuple = ()

    def reset(self):
        """Both engines back to the state they were built with."""
        self.jeng.state, self.eng.state = self.states
        self.jeng.total_latency_s = self.eng.total_latency_s = 0.0
        self.eng._policy_mirror = None
        return self.jeng, self.eng

    def servers(self, **cfg):
        """(JAX server, port server), one fake clock each, not started,
        with a log of every flush: (reason, request ids, lane, padded
        size)."""
        self.reset()
        out = []
        for Server, Config, eng in ((JaxServer, JaxConfig, self.jeng),
                                    (AsyncDartServer, SchedulerConfig,
                                     self.eng)):
            srv = Server(eng, Config(**cfg), clock=FakeClock(), start=False)
            srv.flushes = []
            _log_flushes(srv)
            out.append(srv)
        return out


def _log_flushes(srv):
    dispatch = srv._dispatch_safe

    def logged(reqs, reason):
        srv.flushes.append((reason, [r.rid for r in reqs], reqs[0].lane,
                            srv._bucket_key(sum(r.n for r in reqs))))
        dispatch(reqs, reason)
    srv._dispatch_safe = logged


def make_pair(name):
    """The case's engines: the port's seeded init, handed to JAX in its
    layout; tau at each exit's median of conf - 0.3*alpha over 128
    calibration rows (about half the rows reaching a gate leave there),
    beta_diff 0.3, no adaptation."""
    jcfg, cfg = CASES[name]
    values = _jax_layout(get_family(cfg).init(cfg, seed=7, device="cpu"))
    params = convert.from_jax_params(values, cfg, device="cpu")
    kw = dict(buckets=BUCKETS, adapt=False)
    jeng = JaxEngine.from_config(jcfg, values, **kw)
    eng = DartEngine.from_config(cfg, params, device="cpu", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DS, "_rng_for", _fixed_rng_for)
        cal = eng.collect_calibration(DATA, n=128, batch=128)
        images = DS.make_batch(DATA, range(POOL[0], sum(POOL)),
                               split="eval")[0]
    tau = np.array([np.median(cal.conf[:, s] - 0.3 * cal.alpha)
                    for s in range(eng.n_exits - 1)], np.float32)
    for e in (jeng, eng):
        e.state = e.state.with_policy(tau=tau, beta_diff=0.3)
    return EnginePair(jeng, eng, np.asarray(images, np.float32),
                      (jeng.state, eng.state))


def burst(seed=7, n_bursts=8):
    """A seeded bursty stream: per burst 1-4 requests of 1-5 pool images,
    deadlines 5-80 ms, priorities 0-2, then 4 ms of clock.  Returns
    [[(start, n, deadline_ms, priority), ...] per burst]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_bursts):
        reqs = []
        for _ in range(int(rng.randint(1, 5))):
            n = int(rng.randint(1, 6))
            reqs.append((int(rng.randint(0, POOL[1] - n)), n,
                         float(rng.randint(5, 80)), int(rng.randint(0, 3))))
        out.append(reqs)
    return out


def drive(srv, images, stream, gap_s=0.004):
    """Submit ``stream`` (see :func:`burst`) on the server's fake clock,
    pumping after each burst, then close; returns the futures in submit
    order."""
    futs = []
    for reqs in stream:
        for a, n, ddl, prio in reqs:
            futs.append(srv.submit(images[a:a + n], deadline_ms=ddl,
                                   priority=prio))
        srv._clock.advance(gap_s)
        while srv.pump():
            pass
    srv._clock.advance(1.0)
    srv.close()
    return futs


def edge_rows(eng, x):
    """Rows of ``x`` with a gate whose conf, served alone through the
    port's masked path, lies within EDGE of its tau'."""
    m = eng.infer(x, mode="masked")
    conf = m["conf_stack"].numpy()[:-1].T
    return np.abs(conf - m["eff_thresholds"].numpy()).min(axis=1) < EDGE


def host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
