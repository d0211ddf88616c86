"""Heterogeneous Health-MNIST generator (port of ``hlax/data/generate.py``).

Reproduces the reference's Heterogeneous_Health_MNIST_generate.py:18-218:
28x28 MNIST digits padded to 36x36, rotated per timestep with a disease
effect (45*sigmoid(t) for sick subjects, +5 baseline otherwise, noise
sigma=2), diagonally shifted by idx/10, T=20 timepoints per subject; the four
18x18 quadrant regions are 5-level quantized according to the datatype config
D1..D5; a Bernoulli missingness mask is drawn; data/mask/masked/labels CSVs
are written.

When no MNIST image directory is given, a procedural fallback draws digit-like glyphs ('3' and '6') so
the full pipeline remains runnable end-to-end.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage
from scipy.special import expit as sigmoid

SIDE = 36
N_PIXELS = SIDE * SIDE
T_POINTS = 20

LABEL_COLUMNS = ["subject", "digit", "angle", "disease", "disease_time",
                 "gender", "time_age", "location"]


def region_indices() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The four 18x18 quadrants in flat pixel order
    (Heterogeneous_Health_MNIST_generate.py:120-135)."""
    r = np.arange(SIDE * SIDE).reshape(SIDE, SIDE)
    region_1 = r[0:18, 0:18].ravel()
    region_2 = r[0:18, 18:36].ravel()
    region_3 = np.concatenate([r[18, 0:18], r[19:36, 0:18].ravel()])
    region_4 = np.concatenate([r[18, 18:36], r[19:36, 18:36].ravel()])
    return region_1, region_2, region_3, region_4


def conversion_5(img: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Quantize pixel values of the given region to 5 levels
    (generate.py:58-66: 25/75/125/175/225)."""
    h = img[idx]
    out = np.where(h < 50, 25.0,
                   np.where(h < 100, 75.0,
                            np.where(h < 150, 125.0,
                                     np.where(h < 200, 175.0, 225.0))))
    img = img.copy()
    img[idx] = out
    return img


def quantized_regions(datatype_config: str):
    """Which regions are 5-level quantized per config (generate.py:190-197)."""
    r1, r2, r3, r4 = region_indices()
    regions = []
    if datatype_config != "D1":
        regions.append(r2)
    if datatype_config not in ("D1", "D2"):
        regions.append(r3)
    if datatype_config in ("D4", "D5"):
        regions.append(r4)
    if datatype_config == "D5":
        regions.append(r1)
    return regions


def _synthetic_digit(digit: str, rng: np.random.Generator) -> np.ndarray:
    """Procedural 28x28 glyph standing in for an MNIST image."""
    img = np.zeros((28, 28))
    yy, xx = np.mgrid[0:28, 0:28]
    if digit == "3":
        for cy in (9, 19):
            ring = ((yy - cy) ** 2 + (xx - 15) ** 2)
            img += 255 * np.exp(-((np.sqrt(ring) - 5.5) ** 2) / 3.0) * (xx > 10)
    else:   # '6'
        ring = ((yy - 18) ** 2 + (xx - 14) ** 2)
        img += 255 * np.exp(-((np.sqrt(ring) - 6.0) ** 2) / 3.0)
        img += 255 * np.exp(-((xx - 11) ** 2) / 4.0) * ((yy > 4) & (yy < 18))
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255)


def _load_digit_images(source: Optional[str], digit: str, count: int,
                       rng: np.random.Generator):
    if source:
        files = sorted(glob.glob(os.path.join(source, digit, "*.jpg")))
        if files:
            import matplotlib.pyplot as plt
            return [plt.imread(files[i % len(files)]) for i in range(count)]
    return [_synthetic_digit(digit, rng) for _ in range(count)]


def generate(
    num_3: int = 100,
    num_6: int = 100,
    missing: float = 25.0,
    datatype_config: str = "D4",
    seed: int = 100,
    source: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Generate the dataset in memory. Returns dict with 'data' [N,1296],
    'mask', 'masked_data', 'labels' [N,8] (label column order as reference)."""
    rng = np.random.default_rng(seed)
    time_age = np.arange(0, T_POINTS)
    time_points = np.arange(-9, 11)
    regions = quantized_regions(datatype_config)

    rows, labels = [], []
    subject_index = 0
    for digit, count in (("3", num_3), ("6", num_6)):
        gender = 0 if digit == "3" else 1
        for img28 in _load_digit_images(source, digit, count, rng):
            padded = np.pad(img28, ((4, 4), (4, 4)), "constant")
            sick = rng.binomial(1, 0.5)
            loc = rng.binomial(1, 0.5)
            rotations = rng.normal(0, 2, len(time_points))
            rotations = rotations + (45 * sigmoid(time_points) if sick else 5)
            for idx, rot in enumerate(rotations):
                img = ndimage.rotate(padded, angle=rot, reshape=False)
                img = ndimage.shift(img, shift=idx / 10)
                flat = img.reshape(-1)
                for reg in regions:
                    flat = conversion_5(flat, reg)
                rows.append(flat)
                labels.append([subject_index, float(digit), rot, sick,
                               time_points[idx] if sick else np.nan,
                               gender, time_age[idx], loc])
            subject_index += 1

    data = np.asarray(rows)
    labels = np.asarray(labels, dtype=np.float64)
    mask = rng.choice([0, 1], size=data.shape,
                      p=[missing / 100.0, 1 - missing / 100.0])
    return {"data": data, "mask": mask.astype(np.float64),
            "masked_data": data * mask, "labels": labels}


def types_table(datatype_config: str):
    """Per-pixel (type, dim, nclass) rows matching the quantized regions."""
    quant = set()
    for reg in quantized_regions(datatype_config):
        quant.update(reg.tolist())
    rows = []
    for p in range(N_PIXELS):
        if p in quant:
            rows.append({"type": "cat", "dim": 1, "nclass": 5})
        else:
            rows.append({"type": "real", "dim": 1, "nclass": 1})
    return rows


def write_csvs(out: Dict[str, np.ndarray], destination: str,
               datatype_config: str = "D4", prefix: str = "") -> None:
    """Write data/mask/masked/labels + a matching data_types CSV."""
    os.makedirs(destination, exist_ok=True)
    j = lambda n: os.path.join(destination, prefix + n)
    np.savetxt(j("data.csv"), out["data"], fmt="%d", delimiter=",")
    np.savetxt(j("mask.csv"), out["mask"], fmt="%d", delimiter=",")
    np.savetxt(j("masked_data.csv"), out["masked_data"], fmt="%d", delimiter=",")
    with open(j("labels.csv"), "w") as f:
        f.write(",".join(LABEL_COLUMNS) + "\n")
        for row in out["labels"]:
            f.write(",".join("nan" if np.isnan(v) else
                             (f"{v:.6g}") for v in row) + "\n")
    # shared across splits — no prefix (canonical config: data_types_D4.csv)
    with open(os.path.join(destination,
                           f"data_types_{datatype_config}.csv"), "w") as f:
        f.write("type, dim, nclass\n")
        for r in types_table(datatype_config):
            f.write(f"{r['type']}, {r['dim']}, {r['nclass']}\n")
