"""Procedural synthetic datasets (offline stand-ins for MNIST / CIFAR-10).

A verbatim copy of the JAX package's ``data/datasets.py`` (procedural
numpy), so both packages draw the same samples.  ``_rng_for`` hashes a
``str``, so a sample depends on ``PYTHONHASHSEED``: the two packages
agree within one process.

Everything is *stateless-seeded*: sample i of dataset d is a pure function
of (d.seed, i) — restarting a job replays identical data (fault-tolerance
substrate), and workers can generate any shard without coordination.

``synth-mnist``  — 28×28×1 stroke-glyph digits (bitmap font, random shift/
                   shear/thickness/noise).
``synth-cifar`` — 32×32×3 class-conditioned texture+shape composites with
                   *controlled per-class difficulty* (classes differ in
                   clutter/noise), which is the property DART exploits —
                   paper Fig. 2's easy (car) / medium (cat) / hard (ship)
                   classes map to low/mid/high clutter here.
``synth-latents``— class-conditioned latent blobs for DiT training.
``synth-tokens`` — structured token sequences (pattern grammar) for LM
                   training; per-sequence entropy varies → difficulty.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# 5x7 bitmap font for digits 0-9 (rows of 5 bits, top to bottom)
_DIGIT_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["01110", "10000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00001", "01110"],
}
_FONT = np.zeros((10, 7, 5), np.float32)
for d, rows in _DIGIT_FONT.items():
    for r, bits in enumerate(rows):
        for c, ch in enumerate(bits):
            _FONT[d, r, c] = float(ch == "1")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str = "synth-cifar"
    n_classes: int = 10
    img_res: int = 32
    channels: int = 3
    seed: int = 0
    n_train: int = 50_000
    n_eval: int = 10_000
    # per-class difficulty profile (clutter/noise scale per class);
    # class 1 ("car") easy, 3 ("cat") medium, 8 ("ship") hard — Fig. 2.
    class_noise: tuple = (0.16, 0.05, 0.14, 0.12, 0.16, 0.18, 0.13, 0.15,
                          0.26, 0.2)


def _rng_for(cfg: DatasetConfig, index: int, split: str):
    return np.random.RandomState(
        (hash((cfg.seed, split)) % (2**31 - 1)) ^ (index * 2654435761 % (2**31 - 1)))


def synth_mnist_sample(cfg: DatasetConfig, index: int, split="train"):
    rs = _rng_for(cfg, index, split)
    label = index % cfg.n_classes
    res = cfg.img_res
    glyph = _FONT[label]
    scale = res // 9
    up = np.kron(glyph, np.ones((scale * 1, scale * 1), np.float32))
    thick = rs.randint(0, 2)
    if thick:  # dilate strokes
        up = np.maximum(up, np.roll(up, 1, axis=1))
    img = np.zeros((res, res), np.float32)
    gy, gx = up.shape
    oy = (res - gy) // 2 + rs.randint(-2, 3)
    ox = (res - gx) // 2 + rs.randint(-2, 3)
    oy, ox = np.clip(oy, 0, res - gy), np.clip(ox, 0, res - gx)
    img[oy:oy + gy, ox:ox + gx] = up
    shear = rs.uniform(-0.2, 0.2)
    rows = np.arange(res)
    shift = (shear * (rows - res / 2)).astype(int)
    img = np.stack([np.roll(img[r], shift[r]) for r in range(res)])
    noise = rs.uniform(0.02, 0.16)
    img = np.clip(img * rs.uniform(0.7, 1.0)
                  + noise * rs.rand(res, res), 0, 1)
    return img[:, :, None].astype(np.float32), label


def synth_cifar_sample(cfg: DatasetConfig, index: int, split="train"):
    rs = _rng_for(cfg, index, split)
    label = index % cfg.n_classes
    res = cfg.img_res
    yy, xx = np.mgrid[0:res, 0:res] / res

    # class-specific texture: oriented sinusoid (freq/angle keyed by class)
    freq = 2 + (label % 5) * 2
    angle = (label * 36) * np.pi / 180
    tex = 0.5 + 0.5 * np.sin(2 * np.pi * freq
                             * (xx * np.cos(angle) + yy * np.sin(angle)))
    # class-specific shape mask
    cy, cx = 0.5 + rs.uniform(-0.15, 0.15, 2)
    r = rs.uniform(0.2, 0.35)
    kind = label % 3
    if kind == 0:       # disc
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2
    elif kind == 1:     # square
        mask = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
    else:               # triangle
        mask = (yy - cy + r > 0) & (np.abs(xx - cx) < (yy - cy + r) / 2)
    # class palette
    base = np.array([((label * 37) % 255) / 255.0,
                     ((label * 91 + 60) % 255) / 255.0,
                     ((label * 151 + 120) % 255) / 255.0])
    img = np.zeros((res, res, 3), np.float32)
    bg = rs.uniform(0.2, 0.8, 3)
    img[:] = bg * (0.6 + 0.4 * tex)[:, :, None]
    img[mask] = base * (0.5 + 0.5 * tex[mask])[:, None]
    # controlled difficulty: class-dependent clutter + per-sample jitter
    noise = cfg.class_noise[label % len(cfg.class_noise)] \
        * rs.uniform(0.5, 1.5)
    n_blobs = rs.poisson(noise * 12)
    for _ in range(n_blobs):
        by, bx = rs.randint(0, res, 2)
        br = rs.randint(2, 6)
        col = rs.rand(3)
        ys, xs = np.mgrid[max(0, by - br):min(res, by + br),
                          max(0, bx - br):min(res, bx + br)]
        img[ys, xs] = 0.5 * img[ys, xs] + 0.5 * col
    img = np.clip(img + noise * rs.randn(res, res, 3) * 0.5, 0, 1)
    return img.astype(np.float32), label


def synth_latents_sample(cfg: DatasetConfig, index: int, split="train"):
    """Class-conditioned latent (res/8, res/8, 4) for DiT."""
    rs = _rng_for(cfg, index, split)
    label = index % cfg.n_classes
    res = cfg.img_res // 8
    yy, xx = np.mgrid[0:res, 0:res] / res
    cy, cx = 0.3 + 0.4 * ((label % 3) / 2), 0.3 + 0.4 * ((label // 3) / 3)
    blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02))
    lat = np.stack([blob * np.cos(label), blob * np.sin(label),
                    1 - blob, 0.5 * blob], axis=-1)
    lat = lat + 0.1 * rs.randn(res, res, 4)
    return lat.astype(np.float32), label


def synth_tokens_sample(cfg: DatasetConfig, index: int, seq_len: int,
                        vocab: int, split="train"):
    """Structured sequences: repeated motif grammar with class-dependent
    entropy (harder classes = noisier repetitions)."""
    rs = _rng_for(cfg, index, split)
    label = index % cfg.n_classes
    motif_len = 4 + label % 5
    motif = rs.randint(2, vocab, motif_len)
    noise_p = 0.05 + 0.03 * label
    seq = np.tile(motif, seq_len // motif_len + 1)[:seq_len].copy()
    flips = rs.rand(seq_len) < noise_p
    seq[flips] = rs.randint(2, vocab, flips.sum())
    seq[0] = label % vocab  # class marker token
    return seq.astype(np.int32), label


def make_batch(cfg: DatasetConfig, indices, split="train", kind=None,
               seq_len=None, vocab=None):
    """Materialize a batch (host-side numpy)."""
    kind = kind or ("mnist" if cfg.name == "synth-mnist" else "cifar")
    if kind == "tokens":
        xs, ys = zip(*[synth_tokens_sample(cfg, i, seq_len, vocab, split)
                       for i in indices])
    elif kind == "latents":
        xs, ys = zip(*[synth_latents_sample(cfg, i, split) for i in indices])
    elif kind == "mnist":
        xs, ys = zip(*[synth_mnist_sample(cfg, i, split) for i in indices])
    else:
        xs, ys = zip(*[synth_cifar_sample(cfg, i, split) for i in indices])
    return np.stack(xs), np.asarray(ys, np.int32)


MNIST = DatasetConfig(name="synth-mnist", img_res=28, channels=1)
CIFAR = DatasetConfig(name="synth-cifar", img_res=32, channels=3)
