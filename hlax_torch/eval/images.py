"""Image generation and the training-curve plots (port of
``hlax/eval/images.py``).

The numeric part runs on the model's device: GP prediction of z at the
generation rows (``validate.gp_predict_dataset``), decode, the mode of each
pixel's likelihood (``metrics.statistics``), and the remap of the quantized
5-level quadrants to pixel values (``data.generate.region_indices``).  Only
the drawing needs matplotlib, which is imported inside the plotting
functions, as in hlax.  Where it is missing, the arrays a plot would have
drawn are written to an ``.npz`` of the same name instead and one line says
so; hlax's own functions raise there.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from hlax_torch import to_numpy
from hlax_torch.data.dataset import LongitudinalDataset
from hlax_torch.data.generate import region_indices
from hlax_torch.eval import metrics as mx
from hlax_torch.eval.validate import decode_latents, gp_predict_dataset


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def convert_cat5_to_pixels(x: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """5-level codes -> pixel values 0/50/100/150/200 in the columns
    ``idx`` (a copy)."""
    out = x.copy()
    out[:, idx] = x[:, idx] * 50.0
    return out


def seqrecon_plot(X, recon_X, labels_recon, labels_train, save_file,
                  num_sets: int = 8, seq_length: int = 20) -> str:
    """Original against reconstruction grids: ``num_sets`` pairs of rows of
    ``seq_length`` 36x36 images, each placed at its time label.  Writes
    ``save_file``, or without matplotlib the same arrays to ``save_file``'s
    ``.npz`` (X, recon_X, labels_recon, labels_train, num_sets,
    seq_length).  Returns the path written."""
    plt = _pyplot()
    if plt is None:
        out = os.path.splitext(save_file)[0] + ".npz"
        np.savez(out, X=X, recon_X=recon_X, labels_recon=labels_recon,
                 labels_train=labels_train, num_sets=num_sets,
                 seq_length=seq_length)
        print(f"{save_file} needs matplotlib, which is not installed: wrote "
              f"its grids to {out}", flush=True)
        return out
    fig, ax = plt.subplots(2 * num_sets, seq_length)
    for row in np.atleast_1d(ax).reshape(-1):
        row.set_xticks([])
        row.set_yticks([])
    fig.set_size_inches(3 * num_sets, 3 * num_sets)
    for j in range(num_sets):
        b, e = seq_length * j, seq_length * (j + 1)
        for i, t in enumerate(labels_train[b:e, 0]):
            ax[2 * j, int(t)].imshow(X[b + i].reshape(36, 36), cmap="gray",
                                     interpolation="nearest")
        for i, t in enumerate(labels_recon[b:e, 0]):
            ax[2 * j + 1, int(t)].imshow(recon_X[b + i].reshape(36, 36),
                                         cmap="gray", interpolation="nearest")
    plt.savefig(save_file)
    plt.close("all")
    return save_file


def recon_complete_gen(model, spec0, k0, spec1, k1, noise, zt,
                       gen_ds: LongitudinalDataset,
                       prediction_x: np.ndarray, prediction_mu: np.ndarray,
                       id_covariate: int, results_path: str,
                       epoch: int = -1, n_rows: int = 160,
                       eps: Optional[float] = None,
                       eval_gp_f64: bool = False) -> str:
    """GP-predict z for the first ``n_rows`` rows of the generation set,
    decode, remap the 5-level quadrants to pixel values and draw the
    reconstruction grid (``recon_complete.pdf``, or
    ``recon_complete_<epoch>.pdf``).  Returns the path written."""
    lay = gen_ds.layout
    rows = min(n_rows, len(gen_ds))
    test_x = gen_ds.labels[:rows]
    z_pred = gp_predict_dataset(
        spec0, k0, spec1, k1, noise, zt, prediction_x, prediction_mu,
        prediction_x[:, id_covariate], test_x, test_x[:, id_covariate], eps,
        eval_gp_f64)
    (_, _, params, _), (data, mask, _) = decode_latents(
        model, gen_ds, z_pred, rows=slice(0, rows))
    with torch.inference_mode():
        _, mode_rec = mx.statistics(params, lay, gen_ds.conv)
        truth = to_numpy(mx.discrete_transform(data, lay))[:, lay.raw_inv]
    recon = to_numpy(mode_rec)[:, lay.raw_inv]
    mask_np = to_numpy(mask)[:, lay.raw_inv]

    # quantized quadrants: codes to pixel values; the others from [0, 1]
    for reg in region_indices():
        if truth[:, reg].max() == 4:
            truth = convert_cat5_to_pixels(truth, reg)
            recon = convert_cat5_to_pixels(recon, reg)
        else:
            recon[:, reg] = recon[:, reg] * 255.0

    os.makedirs(results_path, exist_ok=True)
    fname = ("recon_complete.pdf" if epoch == -1
             else f"recon_complete_{epoch}.pdf")
    n_sets = min(8, len(test_x) // 20) or 1
    return seqrecon_plot(truth * mask_np, recon, test_x, test_x,
                         os.path.join(results_path, fname), num_sets=n_sets,
                         seq_length=min(20, gen_ds.T_max))


def plot_training_info(save_path: str, warn: bool = True,
                       **curves: Optional[np.ndarray]) -> List[str]:
    """Training-curve PNGs: net loss, NLL against KL, VAE error, GP error,
    validation loss, each skipped when its curves are absent or empty.
    Without matplotlib the curves go to ``training_curves.npz`` instead, and
    one line says so when ``warn``.  Returns the paths written."""
    os.makedirs(save_path, exist_ok=True)
    plt = _pyplot()
    if plt is None:
        out = os.path.join(save_path, "training_curves.npz")
        np.savez(out, **{k: np.asarray(v, np.float64)
                         for k, v in curves.items() if v is not None})
        if warn:
            print(f"The training-curve plots need matplotlib, which is not "
                  f"installed: writing their curves to {out}", flush=True)
        return [out]

    written = []

    def _plot(name, series, labels):
        series = [s for s in series if s is not None and len(np.atleast_1d(s))]
        if not series:
            return
        fig, ax1 = plt.subplots()
        ax1.plot(np.asarray(series[0]), color="tab:red", label=labels[0])
        ax1.legend(loc=1)
        if len(series) > 1:
            ax2 = ax1.twinx()
            ax2.plot(np.asarray(series[1]), color="tab:blue", label=labels[1])
            ax2.legend(loc=3)
        fig.tight_layout()
        path = os.path.join(save_path, name)
        plt.savefig(path)
        plt.close(fig)
        written.append(path + ".png")

    _plot("training_net_loss", [curves.get("net_loss")], ["Net Loss"])
    nll = curves.get("nll")
    _plot("training_kl_ll",
          [None if nll is None else -np.asarray(nll), curves.get("kld")],
          ["Training Recon LogLik per Variable", "Training KL z"])
    _plot("training_VAE_error", [curves.get("vae_error")],
          ["Training mean or VAE error"])
    _plot("test_GP_error", [curves.get("gp_error")], ["Test mean/GP error"])
    _plot("validation_net_loss", [curves.get("validation_loss")],
          ["Validation Loss"])
    return written
