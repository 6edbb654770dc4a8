"""The reference's precision: float32 with TF32 off, or the control's
TF32 (the nearest precision below float32 that a later change could
reach for).

On the card the control turns on cuBLAS's TF32 products. A CPU has no
TF32, so there the control rounds each product's operands to TF32's 10
mantissa bits (round to nearest even) and passes gradients straight
through: the rounding of the inputs, which is what TF32 does, without
the card."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

MODES = ("f32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, nearest even."""
    u = x.detach().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = ((u ^ 0x80000000) - 0x80000000).to(torch.int32)
    return u.view(torch.float32).view(x.shape)


class Numerics:
    """Where every product of the reference goes (``mm``, ``einsum``)."""

    def __init__(self, mode: str, device: torch.device):
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}: expected one of {MODES}")
        self.mode = mode
        self.device = torch.device(device)
        self.emulate = mode == "tf32" and self.device.type != "cuda"

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        if not self.emulate:
            return x
        return x + (tf32_round(x) - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._r(a) @ self._r(b)

    def einsum(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self._r(x) for x in xs])

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """cuBLAS's and cuDNN's TF32 switches set for this mode, and put
        back after."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32" and self.device.type == "cuda"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
