"""The arithmetic of the plain reference: float32 with TF32 off, or a lower
precision emulated for the control.

Every product of the reference (a convolution, a matrix product, an
attention's logits and its weighted sum) takes its operands through
:meth:`Arith.cast`.  In float32 that is the identity.  The control rounds
the operands to float8 e4m3 with one scale a tensor (its largest magnitude
maps to 448, e4m3's largest), the precision below the bfloat16 that the
configurations state, and leaves the sums in float32.  The rounding is
straight-through: the backward sees the rounded operands that the products
saved, and passes the gradient on unrounded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def tf32_off() -> None:
    """Float32 products in float32 on the card (no TF32), as the reference
    states."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    """``name``: "fp32" (the reference) or "fp8" (rounded operands)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"arith must be fp32 or fp8, got {name!r}")
        self.name = name

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        with torch.no_grad():
            scale = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
            r = (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (r - x).detach()

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.cast(x), self.cast(w), b, stride=stride, padding=padding)

    def conv_t(self, x, w, b, stride):
        return F.conv_transpose2d(self.cast(x), self.cast(w), b, stride=stride)

    def mm(self, a, b):
        return self.cast(a) @ self.cast(b)

    def linear(self, x, w, b=None):
        return F.linear(self.cast(x), self.cast(w), b)
