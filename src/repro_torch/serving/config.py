"""Serving configuration (PyTorch port of ``repro.serving.config``).

The same grouped dataclasses and the same validation at construction.
Settings this slice of the port does not serve yet raise
``NotImplementedError`` naming the ROADMAP item that brings them:
temperature / top-k sampling (C1), backpressure and shedding (C2),
speculative decoding (C4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.train.step import DECODE_KERNELS


@dataclass(frozen=True)
class SamplingConfig:
    """Next-token choice: greedy only (``temperature == 0``)."""
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature={self.temperature} must be >= 0")
        if self.temperature > 0.0 or self.top_k > 0:
            raise NotImplementedError(
                f"temperature={self.temperature}, top_k={self.top_k}: the "
                f"port samples greedily only (ROADMAP C1: temperature/top-k "
                f"sampling)")


@dataclass(frozen=True)
class BackpressureConfig:
    """Admission-queue bounds and shedding. Only the default (unbounded
    queue, no deadline) is served; anything else is ROADMAP C2."""
    max_queue: Optional[int] = None
    admission_deadline: Optional[float] = None

    def __post_init__(self):
        if self.max_queue is not None or self.admission_deadline is not None:
            raise NotImplementedError(
                f"max_queue={self.max_queue}, admission_deadline="
                f"{self.admission_deadline}: the port does not shed load "
                f"yet (ROADMAP C2: backpressure and shedding)")


@dataclass(frozen=True)
class PagingConfig:
    """Paged KV pool layout. ``n_pages`` defaults to
    ``max_batch * max_seq // page_size`` (dense-equivalent capacity);
    divisibility against ``max_seq`` is checked by ``ServingConfig``."""
    page_size: int
    n_pages: Optional[int] = None
    prefix_reuse: bool = True

    def __post_init__(self):
        if self.n_pages is not None and self.n_pages < 1:
            raise ValueError(f"n_pages={self.n_pages} must be >= 1")


@dataclass(frozen=True, eq=False)
class ServingConfig:
    """Everything ``ServingEngine`` needs beyond (params, model cfg)."""
    max_batch: int
    max_seq: int
    prompt_bucket_min: int = 8
    prompt_cap: Optional[int] = None
    decode_kernel: str = "flash"          # "flash" | "plain"
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    backpressure: BackpressureConfig = field(
        default_factory=BackpressureConfig)
    paging: Optional[PagingConfig] = None
    speculative: Optional[Any] = None

    def __post_init__(self):
        cap = self.resolved_prompt_cap
        if not 1 <= cap <= self.max_seq:
            raise ValueError(f"prompt_cap={cap} must lie in "
                             f"[1, max_seq={self.max_seq}]")
        if self.decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel={self.decode_kernel!r}: "
                             f"expected 'flash' or 'plain'")
        if self.paging is not None:
            ps = self.paging.page_size
            if not 1 <= ps <= self.max_seq:
                raise ValueError(f"page_size={ps} must lie in "
                                 f"[1, max_seq={self.max_seq}]")
            if self.max_seq % ps:
                raise ValueError(
                    f"max_seq={self.max_seq} must be a multiple of "
                    f"page_size={ps} (whole pages per row)")
        if self.speculative is not None:
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP C4)")

    @property
    def resolved_prompt_cap(self) -> int:
        return int(self.prompt_cap) if self.prompt_cap is not None \
            else int(self.max_seq)
