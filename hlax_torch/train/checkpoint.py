"""Checkpoint: the whole train state as one ``torch.save``d dict (port of
``hlax/train/checkpoint.py``, which saves one orbax pytree).

``<path>/<name>.pt`` holds the VAE's state dict, the kernel parameters, the
noise, zt, m, H, the Adam state (on CUDA the capturable one, step counts
included), the step count and the generator state, so a restored state
takes the same next step.  ``restore`` replaces Adam's state tensors: a
CUDA graph captured before it no longer fits the state (restore first).
``final`` is the end of a run, ``early_best`` the best validation epoch
under early stopping.
"""

from __future__ import annotations

import os

import torch

from hlax_torch.train.step import TrainState, place_adam_steps

FINAL_NAME = "final"
EARLY_BEST_NAME = "early_best"


def state_dict(state: TrainState) -> dict:
    cpu = lambda t: t.detach().cpu()
    return {
        "vae": {k: cpu(v) for k, v in state.vae.state_dict().items()},
        "k0": [{k: cpu(v) for k, v in p.items()} for p in state.k0],
        "k1": [{k: cpu(v) for k, v in p.items()} for p in state.k1],
        "raw_noise": cpu(state.raw_noise), "zt": cpu(state.zt),
        "m": cpu(state.m), "H": cpu(state.H),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "step": state.step,
    }


def save(path: str, state: TrainState, name: str = FINAL_NAME) -> str:
    target = os.path.join(os.path.abspath(path), f"{name}.pt")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    torch.save(state_dict(state), target)
    return target


def load(path: str, name: str = FINAL_NAME):
    """The saved dict of ``<path>/<name>.pt`` (tensors on the CPU), or None
    if absent."""
    target = os.path.join(os.path.abspath(path), f"{name}.pt")
    if not os.path.isfile(target):
        return None
    return torch.load(target, map_location="cpu", weights_only=False)


def restore(path: str, state: TrainState, name: str = FINAL_NAME) -> bool:
    """Load ``<path>/<name>.pt`` into ``state`` in place; False if absent."""
    sd = load(path, name)
    if sd is None:
        return False
    with torch.no_grad():
        state.vae.load_state_dict(sd["vae"])
        for dst, src in zip(state.k0 + state.k1, sd["k0"] + sd["k1"]):
            for k in dst:
                dst[k].copy_(src[k])
        for k in ("raw_noise", "zt", "m", "H"):
            getattr(state, k).copy_(sd[k])
    # the saved param groups carry the saving run's capturable and fused
    # flags; this optimizer keeps its own (a CUDA run's checkpoint restores
    # on the CPU)
    flags = [{k: g.get(k) for k in ("capturable", "fused")}
             for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(sd["optimizer"])
    for g, own in zip(state.optimizer.param_groups, flags):
        g.update(own)
    place_adam_steps(state.optimizer)
    state.generator.set_state(sd["generator"])
    state.step = sd["step"]
    return True
