"""The conv lowerings of the HLVAE image path (port of
``hlax/ops/convfuse.py``).

Two lowerings of the same stack, with the same parameters:

  * ``conv3x3_same`` and ``conv_transpose4x4_s2``, NCHW with torch's weight
    layouts: cuDNN's convolutions, where hlax leaves them to XLA's.  The
    default path.
  * ``conv_pool_fused`` and ``conv_transpose_fused`` (``--fused_conv``):
    hlax's reformulation of each stage as one patch extraction followed by
    one matmul (cuBLAS), with the summation reordered:
      - conv3x3-SAME + bias + relu + maxpool2x2 as a stride-2 4x4-patch
        extraction -> ``[B*S/2*S/2, 16C] @ [16C, 4O]`` -> relu -> max over
        the 4 positions of the pool window.  The window's receptive field
        is a 4x4 input patch, and ``W[(r,s,c),(u,v,o)] = k[r-u, s-v, c, o]``
        gives all four conv outputs of the window from it;
      - ConvTranspose-4x4-stride2-SAME + bias as a 3x3-patch extraction ->
        ``[B*H*W, 9C] @ [9C, 4O]`` -> depth-to-space: output phase (u, v) is
        a small conv over the input with the kernel taps
        ``k[2r-u, 2s-v]``.
    These run in hlax's layouts, NHWC activations and HWIO kernels, so they
    match hlax's functions argument for argument; the model converts at the
    fused stack's two ends (``conv_kernel_hwio``,
    ``conv_transpose_kernel_hwio``, and one permute of the activations).
    hlax computes them outside any Pallas kernel, and so does the port.

Each takes ``tf32``: the convolutions, or the patch matmul, in TF32 forward
and backward (``hlax_torch.precision``; the model's precision policy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hlax_torch import precision


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """``flax.linen.Conv(O, (3, 3), SAME)``: x [B, C, H, W], weight
    [O, C, 3, 3] (flax kernel ``transpose(3, 2, 0, 1)``)."""
    if tf32:
        return precision.conv2d(x, weight, bias, padding=1)
    return F.conv2d(x, weight, bias, padding=1)


def conv_transpose4x4_s2(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, tf32: bool = False
                         ) -> torch.Tensor:
    """``flax.linen.ConvTranspose(O, (4, 4), (2, 2), SAME)``: x [B, C, H, W]
    -> [B, O, 2H, 2W], weight [C, O, 4, 4] (flax kernel spatially flipped,
    then ``transpose(2, 3, 0, 1)``)."""
    if tf32:
        return precision.conv_transpose2d(x, weight, bias, stride=2,
                                          padding=1)
    return F.conv_transpose2d(x, weight, bias, stride=2, padding=1)


def conv_kernel_hwio(weight: torch.Tensor) -> torch.Tensor:
    """Conv2d weight [O, C, kh, kw] -> flax kernel [kh, kw, C, O]."""
    return weight.permute(2, 3, 1, 0)


def conv_transpose_kernel_hwio(weight: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d weight [C, O, kh, kw] -> flax kernel [kh, kw, C, O]
    (``hlax_torch.convert``'s mapping undone: transpose, then flip)."""
    return weight.permute(2, 3, 0, 1).flip(0, 1)


class _ReluMaxUV(torch.autograd.Function):
    """max over the (u, v) window axes of relu(y), y [..., 2, 2, O].  The
    backward sends the cotangent to every element equal to the window's
    positive maximum (ties replicated, as hlax's custom VJP and
    ``models.hlvae._MaxPool2x2`` do); an all-negative window gets none."""

    @staticmethod
    def forward(ctx, y):
        o = torch.relu(y).amax(dim=(-3, -2))
        ctx.save_for_backward(y, o)
        return o

    @staticmethod
    def backward(ctx, g):
        y, o = ctx.saved_tensors
        hit = (y > 0) & (y == o[..., None, None, :])
        return torch.where(hit, g[..., None, None, :],
                           torch.zeros((), dtype=g.dtype, device=g.device))


def _matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return precision.mm(a, b) if tf32 else a @ b


def _patches(xp: torch.Tensor, offs: int, size: int,
             stride: int) -> torch.Tensor:
    """[B, Hp, Wp, C] padded input -> [B, size, size, offs*offs*C]: channel
    block (r, s) is element (r, s) of the ``offs x offs`` window that starts
    at (stride*p, stride*q); r slowest, then s, then C."""
    span = stride * (size - 1) + 1
    return torch.cat([xp[:, r:r + span:stride, s:s + span:stride, :]
                      for r in range(offs) for s in range(offs)], dim=-1)


def conv_pool_fused(x: torch.Tensor, kernel: torch.Tensor,
                    bias: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """relu(conv3x3_same(x, k, b)) -> 2x2/2 max pool, as one patch matmul.

    x [B, S, S, C] (S even), kernel [3, 3, C, O] -> [B, S//2, S//2, O]."""
    B, S, _, C = x.shape
    O = kernel.shape[-1]
    half = S // 2
    p = _patches(F.pad(x, (0, 0, 1, 1, 1, 1)), 4, half, 2)  # [B,S/2,S/2,16C]
    # W[(r,s,c), (u,v,o)] = kernel[r-u, s-v, c, o] (zero outside 0..2): u
    # zero rows before the kernel's, v zero columns before its columns
    k = kernel.permute(2, 3, 0, 1)                           # [C, O, 3, 3]
    w = torch.stack([F.pad(k, (v, 1 - v, u, 1 - u)).permute(2, 3, 0, 1)
                     for u in (0, 1) for v in (0, 1)], dim=-2)
    w = w.reshape(16 * C, 4 * O)                             # [4,4,C,4,O]
    y = _matmul(p.reshape(B * half * half, 16 * C), w, tf32)
    y = y.reshape(B, half, half, 2, 2, O) + bias
    return _ReluMaxUV.apply(y)


def conv_transpose_fused(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, tf32: bool = False
                         ) -> torch.Tensor:
    """ConvTranspose 4x4 stride-2 SAME + bias as patch matmul +
    depth-to-space.

    x [B, H, W, C], kernel [4, 4, C, O] -> [B, 2H, 2W, O]:
    out[2m+u, 2n+v, o] = sum_{r,s in 0..2} x[m-1+r, n-1+s] k[2r-u, 2s-v]
    (taps outside 0..3 are zero)."""
    B, H, W, C = x.shape
    O = kernel.shape[-1]
    if H != W:
        raise ValueError(f"conv_transpose_fused takes square images, got "
                         f"{H}x{W}")
    p = _patches(F.pad(x, (0, 0, 1, 1, 1, 1)), 3, H, 1)     # [B, H, W, 9C]
    # kext[i] = kernel[i-1] for i in 1..4, zero at 0, 5, 6: tap 2r-u+1 for
    # r = 0, 1, 2 is the strided slice 1-u::2 (slices, not index lists: a
    # list would be copied from the host, which a CUDA graph cannot replay)
    kext = kernel.new_zeros((7, 7, C, O))
    kext[1:5, 1:5] = kernel
    w = torch.stack([kext[1 - u:6 - u:2, 1 - v:6 - v:2] for u in (0, 1)
                     for v in (0, 1)], dim=-2).reshape(9 * C, 4 * O)
    y = _matmul(p.reshape(B * H * W, 9 * C), w, tf32)
    y = y.reshape(B, H, W, 2, 2, O) + bias                   # [.., u, v, O]
    return y.transpose(2, 3).reshape(B, 2 * H, 2 * W, O)
