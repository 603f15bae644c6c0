"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for matmuls and convolutions.
2. build   — nvcc builds ``src/repro_torch/csrc/*.cu`` into one library.
3. kernels — each hand-written kernel against its plain torch version
   on the card over a sweep of shapes, then timed with CUDA events
   (median of 21 blocks after warm-up) beside its bound; the public
   ``softmax_confidence`` op on (..., V) card tensors against the CPU.
4. engine  — VGG-16/CIFAR-10 at full width (4 exits, ~15.5 M params,
   seeded random init) through ``DartEngine``: calibration on
   synth-CIFAR, the joint-DP policy, then a median policy so rows exit
   at several stages; batches of 1, 64, 256, 1024 and 1500 (split) in
   masked and compacted mode; ``update()`` and ``stats()``.  Masked and
   compacted must agree outside the counted threshold-edge rows, at
   least two exits must be taken, the kernel launch counts of this run
   must be exactly what the path implies, and a small batch must agree
   with the same engine on the CPU (plain torch versions).
   Each batch is served five times in each mode; samples/s is the
   median of the last four.
5. engine  — the same for AlexNet/CIFAR-10.
6. the kernels summary line, then the ``ok`` line.

Any failed check raises: the script exits non-zero and prints no ``ok``
line.  Without CUDA it exits 1 before printing anything.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside
#: the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: tolerances of the kernel checks (and why)
CONF_TOL = 1e-5       # fp32 sums over V in another order
EDGE = 1e-5           # |conf - tau'| below this may flip the strict `>`
ALPHA_TOL = 1e-6      # alpha_var / alpha_grad: fp32 means
CPU_EDGE = 1e-4       # card vs CPU: convolutions by other algorithms
CPU_CONF_TOL = 1e-4

#: passes over each engine batch in each mode; all but the first timed
PASSES = 5


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def emit(**obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=21, block=20):
    """Median device time of one call: each of ``reps`` blocks queues
    ``block`` calls behind a sleep kernel (so the host's launch overhead
    is hidden) between two CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(block):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / block)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# bounds: max(bytes moved / HBM rate, operations / fp32 rate), in ms
# ---------------------------------------------------------------------------

def gate_bound(b, v, itemsize):
    nbytes = b * v * itemsize + b * 4 + b * 16   # logits, tau' | 4 outputs
    ops = 6 * b * v                  # sub, exp, add, sub, mul, add per logit
    return bound(nbytes, ops)


def difficulty_bound(b, h, w, c):
    nbytes = b * h * w * c * 4 + b * 16
    # per pixel: channel sums and squared deviations (4c), gray (5); per
    # valid pixel: Sobel pair (22), magnitude + compare (5), |Laplacian|
    # and its sum (8)
    ops = b * (h * w * (4 * c + 5) + (h - 2) * (w - 2) * 35)
    return bound(nbytes, ops)


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def exact_gate(lg):
    """conf and entropy of the same chain in float64 (the yardstick for
    the rounding of both fp32 versions)."""
    x = lg.double()
    d = x - x.amax(dim=1, keepdim=True)
    e = d.exp()
    s = e.sum(dim=1)
    return 1.0 / s, s.log() - (d * e).sum(dim=1) / s


def gate_inputs(b, v, gen):
    lg = torch.randn(b, v, device="cuda", generator=gen) * 4
    rows = torch.arange(0, b, 2, device="cuda")       # exact ties
    top = lg[rows].amax(dim=1) + 1.0
    i = torch.randint(0, v // 2, (len(rows),), device="cuda", generator=gen)
    lg[rows, i] = top
    lg[rows, i + v // 2] = top
    th = torch.rand(b, device="cuda", generator=gen)
    return lg, th


GATE_CASES = ([(b, v, torch.float32) for b in (1, 7, 256, 1024)
               for v in (10, 1000, 32000, 129280)]
              + [(256, 1000, torch.bfloat16), (7, 129280, torch.float16)])


def check_exit_gate(ref, kern, gen):
    worst = {"conf": 0.0, "entropy": 0.0, "conf_vs_exact": 0.0,
             "entropy_vs_exact": 0.0}
    for b, v, dtype in GATE_CASES:
        lg, th = gate_inputs(b, v, gen)
        lg = lg.to(dtype)         # the plain version upcasts the same
        planted = torch.arange(b, device="cuda") % 3 == 1
        th = torch.where(planted, ref.ref_exit_gate(lg, th)[0], th)
        want = ref.ref_exit_gate(lg, th)
        got = kern.exit_gate_cuda(lg, th)
        torch.cuda.synchronize()
        conf64, ent64 = exact_gate(lg)
        errs = {}
        for name, k, p, x in (("conf", got[0], want[0], conf64),
                              ("entropy", got[1], want[1], ent64)):
            k, p = k.double(), p.double()
            gap, own = (k - p).abs(), (p - x).abs()
            errs[name] = float(gap.max())
            errs[name + "_vs_exact"] = float((k - x).abs().max())
            errs["plain_" + name + "_vs_exact"] = float(own.max())
            # the kernel must be within CONF_TOL of the exact value and
            # of the plain fp32 version, up to that version's own
            # rounding (fp32 sums of 129 280 terms)
            check(errs[name + "_vs_exact"] <= CONF_TOL,
                  f"exit_gate {name} off the exact value at {(b, v)}")
            check(bool((gap <= CONF_TOL + own).all()),
                  f"exit_gate {name} off the plain version at {(b, v)}")
        check(torch.equal(got[2], want[2]),
              f"exit_gate pred differs at {(b, v)}")
        check(bool((got[2][::2] < v // 2).all()),
              "exit_gate tie not resolved to the lowest index")
        edge = (want[0] - th).abs() < EDGE
        check(int(edge.sum()) >= int(planted.sum()),
              "planted tau' == conf rows not counted as edge rows")
        check(torch.equal(got[3][~edge], want[3][~edge]),
              f"exit_gate fire differs outside edge rows at {(b, v)}")
        check(not bool(got[3][planted & (got[0] == th)].any()),
              "exit_gate fires at conf == tau'")
        ms = time_ms(lambda: kern.exit_gate_cuda(lg, th))
        plain_ms = time_ms(lambda: ref.ref_exit_gate(lg, th))
        bms, by = gate_bound(b, v, lg.element_size())
        emit(phase="kernels", kernel="exit_gate", shape=[b, v],
             dtype=str(dtype).removeprefix("torch."),
             edge_rows=int(edge.sum()), ms=ms, plain_ms=plain_ms,
             bound_ms=bms, bound_by=by, **errs)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
    return worst


def check_softmax_confidence(gen):
    """``dispatch.softmax_confidence`` (the gate kernel with tau' = 1) on
    (..., V) card tensors, one of them not contiguous, against the same
    op on the CPU, which takes the plain version."""
    from repro_torch.kernels import dispatch
    worst = 0.0
    for shape, dtype in (((4, 64, 10), torch.float32),
                         ((3, 5, 1000), torch.bfloat16)):
        lg = (torch.randn(*shape, device="cuda", generator=gen) * 4).to(dtype)
        lg = lg.transpose(0, 1)
        conf, pred = dispatch.softmax_confidence(lg)
        want_conf, want_pred = dispatch.softmax_confidence(lg.cpu())
        check(conf.device.type == pred.device.type == "cuda",
              "softmax_confidence left the card")
        check(conf.shape == pred.shape == want_conf.shape == lg.shape[:-1],
              f"softmax_confidence shape {tuple(conf.shape)} at {shape}")
        err = float((conf.cpu() - want_conf).abs().max())
        check(err <= CONF_TOL, f"softmax_confidence conf off at {shape}")
        check(torch.equal(pred.cpu(), want_pred),
              f"softmax_confidence pred differs at {shape}")
        emit(phase="kernels", kernel="exit_gate", op="softmax_confidence",
             shape=list(lg.shape), dtype=str(dtype).removeprefix("torch."),
             err_conf=err)
        worst = max(worst, err)
    return worst


def check_difficulty(ref, kern, gen, cfg):
    kw = dict(tau_edge=cfg.tau_edge, var_scale=cfg.var_scale,
              grad_scale=cfg.grad_scale, w1=cfg.w_edge, w2=cfg.w_variance,
              w3=cfg.w_gradient)
    worst = 0.0
    for b in (1, 256, 1024):
        for h, w, c in ((32, 32, 3), (28, 28, 1), (224, 224, 3)):
            x = torch.rand(b, h, w, c, device="cuda", generator=gen)
            x[: b // 2] = torch.round(x[: b // 2])          # hard edges
            want = ref.ref_components(x, **kw)
            got = kern.difficulty_cuda(x, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().amax(dim=0).tolist()
            pixel = 1.0 / ((h - 2) * (w - 2))
            check(err[0] <= pixel + 1e-7, f"alpha_edge off at {(b, h, w, c)}")
            check(max(err[1:3]) <= ALPHA_TOL,
                  f"alpha_var/alpha_grad off at {(b, h, w, c)}")
            check(err[3] <= cfg.w_edge * pixel + ALPHA_TOL,
                  f"alpha off at {(b, h, w, c)}")
            ms = time_ms(lambda: kern.difficulty_cuda(x, **kw))
            plain_ms = time_ms(lambda: ref.ref_components(x, **kw))
            bms, by = difficulty_bound(b, h, w, c)
            emit(phase="kernels", kernel="difficulty", shape=[b, h, w, c],
                 err_edge=err[0], err_var=err[1], err_grad=err[2],
                 err_alpha=err[3], ms=ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by)
            worst = max(worst, max(err))
    return worst


# ---------------------------------------------------------------------------
# phases 4-5: the engine on the main path
# ---------------------------------------------------------------------------

def edge_rows(masked, tol):
    conf = masked["conf_stack"][:-1].T
    return ((conf - masked["eff_thresholds"]).abs().min(dim=1).values
            < tol).cpu().numpy()


def drive_engine(cfg, name, data, offset):
    from repro_torch.convert import leaves
    from repro_torch.data.datasets import make_batch
    from repro_torch.engine import DartEngine
    from repro_torch.kernels import dispatch
    from repro_torch.models import get_family

    params = get_family(cfg).init(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    eng = DartEngine.from_config(cfg, params)          # the card by default
    check(eng.device.type == "cuda", "engine not on the card")
    batches = [make_batch(data, range(offset + a, offset + a + n),
                          split="eval")[0]
               for a, n in ((0, 1), (1, 64), (65, 256), (321, 1024),
                            (1345, 1500))]

    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    cal = eng.collect_calibration(data, n=512, batch=64)
    pol = eng.calibrate(cal)
    cal_s = time.perf_counter() - t0
    expect = {"difficulty": 512 // 64, "exit_gate": 0}
    # tau at each exit's median of conf - beta_diff*alpha: about half the
    # rows reaching a gate leave there, so compaction really runs
    bd = float(pol.beta_diff)
    tau = np.array([np.median(cal.conf[:, s] - bd * cal.alpha)
                    for s in range(eng.n_exits - 1)], np.float32)
    eng.state = eng.state.with_policy(tau=tau)

    rows, exits, total_edge = [], np.zeros(eng.n_exits, np.int64), 0
    for x in batches:
        t_masked, t_comp = [], []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masked = eng.infer(x, mode="masked")
            m_idx = masked["exit_idx"].cpu().numpy()
            torch.cuda.synchronize()
            t_masked.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            comp = eng.infer(x, mode="compacted")
            torch.cuda.synchronize()
            t_comp.append(time.perf_counter() - t0)
            expect["difficulty"] += 1 + len(eng.compactor.chunks(len(x)))
            for a, z in eng.compactor.chunks(len(x)):
                expect["exit_gate"] += int(comp["exit_idx"][a:z].max()) + 1
            edge = edge_rows(masked, EDGE)
            ok = ~edge
            check(np.array_equal(comp["exit_idx"][ok], m_idx[ok]),
                  f"{name}: masked and compacted exits differ, b={len(x)}")
            check(np.array_equal(comp["pred"][ok],
                                 masked["pred"].cpu().numpy()[ok]),
                  f"{name}: masked and compacted preds differ, b={len(x)}")
            check(np.isfinite(comp["conf"]).all(), f"{name}: non-finite conf")
            exits += np.bincount(comp["exit_idx"], minlength=eng.n_exits)
            total_edge += int(edge.sum())
        # the first pass meets new shapes; the median of the rest
        rows.append({"batch": len(x), "edge_rows": int(edge.sum()),
                     "exit_counts": np.bincount(
                         comp["exit_idx"], minlength=eng.n_exits).tolist(),
                     "masked_samples_per_s":
                         len(x) / float(np.median(t_masked[1:])),
                     "compacted_samples_per_s":
                         len(x) / float(np.median(t_comp[1:]))})
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    check(counts == expect, f"{name}: launch counts {counts} != {expect}")
    check(all(counts[k] > 0 for k in counts), f"{name}: a kernel never ran")
    check(int((exits > 0).sum()) >= 2, f"{name}: fewer than 2 exits taken")

    eng.update()
    st = eng.stats()
    check(st["served"] == PASSES * sum(len(x) for x in batches),
          f"{name}: served {st['served']}")
    check(np.array_equal(st["exit_counts"], exits),
          f"{name}: stats exit counts {st['exit_counts']} != {exits}")
    cpu_check = check_against_cpu(cfg, params, eng, batches[1])
    emit(phase="engine", model=name, params=n_params,
         exits=eng.n_exits, calibration_s=cal_s, tau=tau.tolist(),
         joint_dp_tau=np.asarray(pol.tau).tolist(), launches=counts,
         edge_rows=total_edge, exit_counts=exits.tolist(),
         served=st["served"], active_strategy=st["active_strategy"],
         mean_macs=st["mean_macs"], batches=rows, cpu_reference=cpu_check)
    return counts


def check_against_cpu(cfg, params, eng, x):
    """The card's compacted answers on one batch against the same engine
    on the CPU (plain torch versions of both kernels)."""
    from repro_torch.engine import DartEngine
    cpu = DartEngine.from_config(cfg, params, device="cpu", adapt=False)
    cpu.state = cpu.state.with_policy(
        tau=eng.state.tau.cpu(), coef=eng._coef().cpu(),
        beta_diff=eng.state.beta_diff.cpu())
    masked = cpu.infer(x, mode="masked")
    card = eng.infer(x, mode="compacted", record=False)
    ok = ~edge_rows(masked, CPU_EDGE)
    check(np.array_equal(card["exit_idx"][ok],
                         masked["exit_idx"].numpy()[ok]),
          "card and CPU exits differ")
    check(np.array_equal(card["pred"][ok], masked["pred"].numpy()[ok]),
          "card and CPU preds differ")
    err = float(np.abs(card["conf"][ok] - masked["conf"].numpy()[ok]).max())
    check(err <= CPU_CONF_TOL, f"card and CPU conf differ by {err}")
    return {"rows": len(x), "edge_rows": int((~ok).sum()),
            "max_conf_err": err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the synthetic datasets seed each sample from hash((seed, split)),
        # a str hash: fix it so every run serves the same images
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.paper_testbeds import ALEXNET_CIFAR, VGG16_CIFAR
    from repro_torch.core.difficulty import DEFAULT
    from repro_torch.data.datasets import CIFAR
    from repro_torch.kernels import build
    from repro_torch.kernels.difficulty import kernel as dkern
    from repro_torch.kernels.difficulty import ref as dref
    from repro_torch.kernels.exit_gate import kernel as gkern
    from repro_torch.kernels.exit_gate import ref as gref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32_matmul=False, tf32_cudnn=False)

    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    emit(phase="build", seconds=time.perf_counter() - t0, library=str(lib))

    gen = torch.Generator(device="cuda").manual_seed(0)
    gate_err = check_exit_gate(gref, gkern, gen)
    softmax_err = check_softmax_confidence(gen)
    diff_err = check_difficulty(dref, dkern, gen, DEFAULT)

    vgg = drive_engine(VGG16_CIFAR, "vgg16-cifar", CIFAR, offset=2000)
    drive_engine(ALEXNET_CIFAR, "alexnet-cifar", CIFAR, offset=6000)

    # main-path shapes: one 1024-row bucket, 10 classes / 32x32x3 images
    lg, th = gate_inputs(1024, 10, gen)
    img = torch.rand(1024, 32, 32, 3, device="cuda", generator=gen)
    kw = dict(tau_edge=DEFAULT.tau_edge, var_scale=DEFAULT.var_scale,
              grad_scale=DEFAULT.grad_scale, w1=DEFAULT.w_edge,
              w2=DEFAULT.w_variance, w3=DEFAULT.w_gradient)
    gate_b, gate_by = gate_bound(1024, 10, 4)
    diff_b, diff_by = difficulty_bound(1024, 32, 32, 3)
    summary = {"kernels": [
        {"name": "exit_gate", "route": "cuda",
         "source": "src/repro_torch/csrc/exit_gate.cu",
         "replaces": "src/repro/kernels/exit_gate/exit_gate_kernel.py:65",
         "launches": vgg["exit_gate"],
         "max_abs_err": max(gate_err["conf"], gate_err["entropy"],
                            softmax_err),
         "ms": time_ms(lambda: gkern.exit_gate_cuda(lg, th)),
         "plain_ms": time_ms(lambda: gref.ref_exit_gate(lg, th)),
         "bound_ms": gate_b, "bound_by": gate_by, "library_ms": None,
         "shape": [1024, 10]},
        {"name": "difficulty", "route": "cuda",
         "source": "src/repro_torch/csrc/difficulty.cu",
         "replaces": "src/repro/kernels/difficulty/difficulty_kernel.py:86",
         "launches": vgg["difficulty"], "max_abs_err": diff_err,
         "ms": time_ms(lambda: dkern.difficulty_cuda(img, **kw)),
         "plain_ms": time_ms(lambda: dref.ref_components(img, **kw)),
         "bound_ms": diff_b, "bound_by": diff_by, "library_ms": None,
         "shape": [1024, 32, 32, 3]},
    ]}
    for k in summary["kernels"]:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                "bound_ms")),
              "non-finite timing")
    print(nvidia_smi(), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
