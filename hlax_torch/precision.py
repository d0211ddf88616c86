"""hlax's float32 precision split (``hlax/gp/elbo.py:31-43``).

hlax runs its GP at "highest" matmul precision (``_highest_precision``
wraps the bound, the natural-gradient update and the predictor) and its
VAE -- the convolutions, the patch matmuls of ``--fused_conv``, the dense
layers -- at JAX's default precision, which on an H100 is TF32 (JAX's own
``lax.Precision`` docstring: DEFAULT "on GPU: uses tensorfloat32 if
available"; HIGHEST "on GPU: uses float32").  A user steers that default
with ``JAX_DEFAULT_MATMUL_PRECISION``; the port reads the same variable
with the same names (``from_env``) into ``HLVAEConfig.precision``.

``import hlax_torch`` turns TF32 off for cuBLAS and cuDNN, and nothing here
leaves it on: the VAE's float32 operations go through the autograd
Functions below (``linear``, ``conv2d``, ``conv_transpose2d``, ``mm``),
which switch TF32 on around their own forward and backward operations
only, and the GP's entry points run under ``highest``, as hlax's do, so an
ambient setting reaches none of them.  The legacy ``allow_tf32`` flags are
the one API used for both.  TF32 changes nothing on the CPU; each
Function's backward makes the same operations autograd makes for the
plain call, so on the CPU the policy gives the plain call's bits.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
import torch.nn.functional as F

ENV = "JAX_DEFAULT_MATMUL_PRECISION"
DEFAULT = "default"
# JAX's names (``jax.lax.Precision``'s aliases) -> whether float32 runs in
# TF32 on an H100: DEFAULT and HIGH take TF32 there, HIGHEST full float32
NAMES = {"default": True, "fastest": True, "bfloat16": True, "high": True,
         "bfloat16_3x": True, "tensorfloat32": True,
         "highest": False, "float32": False}


def uses_tf32(name: str) -> bool:
    """Whether the precision ``name`` runs the VAE's float32 operations in
    TF32 on the card."""
    try:
        return NAMES[name]
    except KeyError:
        raise ValueError(f"unknown matmul precision {name!r}; JAX's names "
                         f"are {sorted(NAMES)}") from None


def from_env() -> str:
    """The precision ``JAX_DEFAULT_MATMUL_PRECISION`` asks for (checked),
    ``DEFAULT`` when it is unset or empty."""
    name = os.environ.get(ENV) or DEFAULT
    uses_tf32(name)
    return name


@contextlib.contextmanager
def tf32(on: bool = True):
    """cuBLAS and cuDNN take TF32 for float32 inside the block (or not,
    ``on=False``); the flags are restored on the way out, an exception's
    too."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def highest(fn):
    """``fn`` in full float32 whatever the ambient flags (hlax's
    ``_highest_precision``)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with tf32(False):
            return fn(*args, **kwargs)
    return wrapped


def _col_major(t: torch.Tensor) -> bool:
    return t.stride(0) == 1 and t.stride(1) == t.shape[0]


def _mm_grads(g, a, b, need):
    """autograd's gradients of ``a.mm(b)``, operation for operation
    (``mm_mat1_backward``, ``mm_mat2_backward``: a column-major operand gets
    its gradient column-major)."""
    ga = gb = None
    if need[0]:
        ga = b.mm(g.t()).t() if _col_major(a) else g.mm(b.t())
    if need[1]:
        gb = g.t().mm(a).t() if _col_major(b) else a.t().mm(g)
    return ga, gb


class _Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with tf32():
            return a.mm(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with tf32():
            return _mm_grads(g, a, b, ctx.needs_input_grad)


class _Linear(torch.autograd.Function):
    """``F.linear`` of a 2-D input with a bias: ``addmm(b, x, w.t())``."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with tf32():
            return F.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with tf32():
            gx, gwt = _mm_grads(g, x, w.t(), ctx.needs_input_grad)
        # the bias's gradient: autograd's sum of the broadcast rows
        gb = g.sum(0, keepdim=True).view(-1) if ctx.needs_input_grad[2] \
            else None
        return gx, None if gwt is None else gwt.t(), gb


class _Conv(torch.autograd.Function):
    """``aten.convolution`` (2-D, with a bias, no dilation or groups) and
    autograd's own ``convolution_backward`` of it."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, transposed):
        ctx.save_for_backward(x, w)
        # stride, padding, dilation, transposed, output padding, groups
        ctx.conv = ([stride] * 2, [padding] * 2, [1, 1], transposed, [0, 0],
                    1)
        ctx.bias = [b.shape[0]]
        with tf32():
            return torch.ops.aten.convolution(x, w, b, *ctx.conv)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with tf32():
            grads = torch.ops.aten.convolution_backward(
                g, x, w, ctx.bias, *ctx.conv, list(ctx.needs_input_grad[:3]))
        return (*grads, None, None, None)


def linear(x, w, b):
    """``F.linear(x, w, b)`` for a 2-D ``x``, in TF32 forward and backward."""
    return _Linear.apply(x, w, b)


def mm(a, b):
    """``a @ b`` of 2-D tensors, in TF32 forward and backward."""
    return _Mm.apply(a, b)


def conv2d(x, w, b, stride: int = 1, padding: int = 0):
    """``F.conv2d`` in TF32 forward and backward."""
    return _Conv.apply(x, w, b, stride, padding, False)


def conv_transpose2d(x, w, b, stride: int = 1, padding: int = 0):
    """``F.conv_transpose2d`` in TF32 forward and backward."""
    return _Conv.apply(x, w, b, stride, padding, True)
