"""hlax_torch — the PyTorch/CUDA port of hlax (heterogeneous longitudinal VAE).

The JAX package ``hlax`` is the reference; this package mirrors its module
layout and is held against it on identical inputs and weights
(``tests/test_torch_*.py``).  It imports ``torch`` and never ``jax``.

TF32 is off for cuBLAS and cuDNN after import, and stays off between calls.
hlax splits float32 precision in two (``hlax/gp/elbo.py:31-43``): the GP at
"highest", the VAE at JAX's default, TF32 on an H100.  The port does the
same per operation, never globally: ``hlax_torch.precision`` switches TF32
on around the VAE's own convolutions and matmuls, forward and backward
(``HLVAEConfig.precision``), and the GP runs in full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another.  Raises when CUDA is asked for and missing — the port never
    falls back to the CPU on its own."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hlax_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def to_numpy(t: torch.Tensor):
    """``t`` as a numpy array on the host; bfloat16, which numpy lacks,
    comes back as float32 (every bfloat16 value is a float32 value)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


_CONSTANTS: dict = {}


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``values`` (array-like) as a tensor on ``device``, uploaded once and
    kept: the train step's host-side constants go through here, because a
    CUDA graph's capture cannot copy from the host.  Treat it as
    read-only."""
    import numpy as np

    a = np.ascontiguousarray(values)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t
