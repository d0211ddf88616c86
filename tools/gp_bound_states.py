"""The KL bound's float32 d m, through its kernels and through its plain
version, against float64, over the training states of ``chip_smoke.py``'s
``[longT T=500]``.

    python3 tools/gp_bound_states.py

``[longT T=500]`` holds the bound's kernels to 4x the float32 plain
version's own error (``chip_smoke._gp_bound_error``) on one state: the
one its training leaves, which cuDNN's atomic weight gradients change
from run to run.  This tool trains that configuration (L = 32, M = 120,
the conv model, 20 subjects of T = 500, 2 a batch, float32) REPS times
from the same seed and, after each of its steps 4 to STEPS, runs
``chip_smoke._gp_bound_case`` on the first batch as ``[longT]`` does and
prints d m's error (with H's and m's gradients) against the plain version
in float64 on the same inputs: the plain version's in float32, the
kernels', and the kernels' with the Function's float32 cuBLAS products
made in double and rounded to float (``iKm``: iK0zz m alone; ``all``:
every bmm and matmul), each beside the plain version's.  Then the spread
of each ratio over the states.

Needs a card and nvcc.
"""
import contextlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

REPS, STEPS = 3, 10
# d m's place in ``chip_smoke._gp_bound_run``'s outputs with H's and m's
# gradients: the terms, P_batch, kld_total, then the 11 leaves' gradients
DM = 3 + cs.GP_BOUND_LEAVES.index("m")
_BMM, _MATMUL = torch.bmm, torch.matmul


def _in_double(f, vectors_only):
    """``f`` computing float32 products in double, rounded to float."""
    def g(a, b, *rest, out=None):
        if a.dtype != torch.float32 or (vectors_only and b.shape[-1] != 1):
            return f(a, b, *rest, out=out) if out is not None else \
                f(a, b, *rest)
        r = f(a.double(), b.double(), *rest).float()
        return out.copy_(r) if out is not None else r
    return g


@contextlib.contextmanager
def products(mode):
    """The Function's float32 products as they are (``kernel``), iKm in
    double (``iKm``) or all of them (``all``)."""
    if mode != "kernel":
        torch.bmm = _in_double(_BMM, mode == "iKm")
    if mode == "all":
        torch.matmul = _in_double(_MATMUL, False)
    try:
        yield
    finally:
        torch.bmm, torch.matmul = _BMM, _MATMUL


def main():
    if not torch.cuda.is_available():
        print("FAIL: no card", flush=True)
        sys.exit(2)
    from hlax_torch.data.dataset import (epoch_subject_batches, gather_batch,
                                         stage_dataset, subject_batches)
    from hlax_torch.gp.kernels import noise_value
    from hlax_torch.models.hlvae import HLVAE, HLVAEConfig
    from hlax_torch.ops import cuda_build
    from hlax_torch.train import step as tstep

    cuda_build.build_all(cs.LIBRARIES)
    spec0, spec1 = cs.long_t_specs()
    T, P, S = cs.LONG_T[1]
    ds = cs.long_t_dataset(T, P)
    cfg = tstep.TrainConfig(latent_dim=32, M=120, P_tot=float(P),
                            N_tot=float(len(ds)), id_covariate=2,
                            natural_gradient=True, constrain_scales=True)
    ratios = {"kernel": [], "iKm": [], "all": []}
    for rep in range(REPS):
        model = HLVAE(HLVAEConfig(layout=ds.layout, z_dim=32, h_dims=(500,),
                                  y_dim=5, conv=True),
                      torch.Generator(device="cuda").manual_seed(0), "cuda")
        state = tstep.init_train_state(model, spec0, spec1,
                                       next(subject_batches(ds, S)), cfg)
        staged = stage_dataset(ds, torch.float32, "cuda")
        step = tstep.make_train_step(model, spec0, spec1, cfg)
        batches = [torch.as_tensor(b, device="cuda") for b in
                   epoch_subject_batches(P, S, np.random.default_rng(0))]
        for k, b in enumerate(batches[:STEPS], 1):
            step(state, gather_batch(staged, b))
            if k < 4:
                continue
            batch = gather_batch(staged, batches[0])
            with torch.no_grad():
                mu, lv = state.vae.encode(batch["data"], batch["mask"])
            case = cs._gp_bound_case(dict(
                batch=batch, specs=(spec0, spec1), k0=state.k0, k1=state.k1,
                noise=noise_value(state.raw_noise,
                                  cfg.constrain_scales).detach(),
                zt=state.zt, eps=cfg.eps, H=state.H.detach(),
                m=state.m.detach(), mu=mu, log_var=lv))
            case64 = ([t.double() for t in case[0]], case[1].double())
            ref = cs._gp_bound_run(False, case64, True)[DM]
            err = lambda g: (g.double() - ref).abs().max().item()
            plain = err(cs._gp_bound_run(False, case, True)[DM])
            got = {}
            for mode in ratios:
                with products(mode):
                    got[mode] = err(cs._gp_bound_run(True, case, True)[DM])
                ratios[mode].append(got[mode] / plain)
            print(f"[states] run {rep} after step {k}: d m's largest entry "
                  f"{ref.abs().max().item():.3e}; float32 error: plain "
                  f"{plain:.3e}; "
                  + "; ".join(f"{mode} {e:.3e} ({e / plain:.2f}x)"
                              for mode, e in got.items())
                  + f" on {cs.card_line()}", flush=True)
        del model, state, staged, step
        torch.cuda.empty_cache()
    for mode, r in ratios.items():
        print(f"[states] {mode}: error / the plain version's, min "
              f"{min(r):.2f}, median {np.median(r):.2f}, max {max(r):.2f} "
              f"over {len(r)} states", flush=True)


if __name__ == "__main__":
    main()
