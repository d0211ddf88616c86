"""The two conv lowerings of the HLVAE image path (port of the reference
lowerings in ``hlax/ops/convfuse.py``:40-56).

hlax leaves these to XLA's convolutions, so the port leaves them to cuDNN.
Layouts are NCHW with torch's weight layouts; ``hlax_torch.convert`` maps
flax kernels onto them.  The fused patch-matmul path of hlax is off by
default there and is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``flax.linen.Conv(O, (3, 3), SAME)``: x [B, C, H, W], weight
    [O, C, 3, 3] (flax kernel ``transpose(3, 2, 0, 1)``)."""
    return F.conv2d(x, weight, bias, padding=1)


def conv_transpose4x4_s2(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """``flax.linen.ConvTranspose(O, (4, 4), (2, 2), SAME)``: x [B, C, H, W]
    -> [B, O, 2H, 2W], weight [C, O, 4, 4] (flax kernel spatially flipped,
    then ``transpose(2, 3, 0, 1)``)."""
    return F.conv_transpose2d(x, weight, bias, stride=2, padding=1)
