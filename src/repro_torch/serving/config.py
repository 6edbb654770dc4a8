"""Serving configuration (PyTorch port of ``repro.serving.config``).

The same grouped dataclasses and the same validation at construction:

  SamplingConfig       temperature / top_k / sample_seed
  BackpressureConfig   max_queue / shed_policy / admission_deadline
  PagingConfig         page_size / n_pages / prefix_reuse
  SpeculativeConfig    draft_params / draft_cfg / k / window

``ServingEngine(params, cfg, serving=ServingConfig(...))`` is the entry
point; ``ServingConfig.from_flat`` is the kwargs-shaped builder.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.train.step import DECODE_KERNELS


@dataclass(frozen=True)
class SamplingConfig:
    """Next-token choice: greedy when ``temperature == 0``, else
    temperature / top-k sampling whose draws are a pure function of
    (``sample_seed``, request id, token index, the row's logits)."""
    temperature: float = 0.0
    top_k: int = 0
    sample_seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature={self.temperature} must be >= 0")


@dataclass(frozen=True)
class BackpressureConfig:
    """Admission-queue bounds and shedding."""
    max_queue: Optional[int] = None
    shed_policy: str = "reject"
    admission_deadline: Optional[float] = None

    def __post_init__(self):
        if self.shed_policy not in ("reject", "drop_oldest"):
            raise ValueError(f"shed_policy={self.shed_policy!r}: expected "
                             f"'reject' or 'drop_oldest'")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")


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
class SpeculativeConfig:
    """Speculative decoding: a small draft LM proposes ``k`` tokens per
    round and the served model verifies them in ONE prefill-chunk-shaped
    dispatch. ``window`` is the draft's cacheless context length —
    history is truncated to the last ``window - k`` tokens, which moves
    only the ACCEPTANCE RATE, never the output (the accept rule emits
    exactly the target model's greedy stream). ``draft_cfg`` must be an
    attention LM over (at least) the served vocab; greedy sampling
    only. ``draft_params`` lie on the engine's device."""
    draft_params: Any
    draft_cfg: Any                       # ArchConfig (kept Any: no dep cycle)
    k: int = 4
    window: int = 16

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k={self.k} must be >= 1")
        if self.window <= self.k:
            raise ValueError(
                f"speculative window={self.window} must exceed k={self.k} "
                f"(the draft needs at least one history token)")


@dataclass(frozen=True, eq=False)
class ServingConfig:
    """Everything ``ServingEngine`` needs beyond (params, model cfg).
    ``start_version`` numbers the initial params (a training step when
    they come from a checkpoint)."""
    max_batch: int
    max_seq: int
    prompt_bucket_min: int = 8
    prompt_cap: Optional[int] = None
    start_version: int = 0
    decode_kernel: str = "flash"          # "flash" | "plain"
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    backpressure: BackpressureConfig = field(
        default_factory=BackpressureConfig)
    paging: Optional[PagingConfig] = None
    speculative: Optional[SpeculativeConfig] = None

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
            if self.sampling.temperature != 0.0:
                raise ValueError(
                    f"speculative decoding requires greedy sampling "
                    f"(temperature=0), got temperature="
                    f"{self.sampling.temperature}")
            if self.speculative.k + 1 > cap:
                raise ValueError(
                    f"speculative draft k={self.speculative.k} exceeds "
                    f"prompt_cap={cap} (a verify chunk carries k+1 "
                    f"tokens and must fit one prefill chunk)")

    @property
    def resolved_prompt_cap(self) -> int:
        return int(self.prompt_cap) if self.prompt_cap is not None \
            else int(self.max_seq)

    @classmethod
    def from_flat(cls, *, max_batch: int, max_seq: int,
                  prompt_bucket_min: int = 8,
                  prompt_cap: Optional[int] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  sample_seed: int = 0, start_version: int = 0,
                  max_queue: Optional[int] = None,
                  shed_policy: str = "reject",
                  admission_deadline: Optional[float] = None,
                  page_size: Optional[int] = None,
                  n_pages: Optional[int] = None,
                  prefix_reuse: bool = True,
                  decode_kernel: str = "flash",
                  speculative: Optional[SpeculativeConfig] = None
                  ) -> "ServingConfig":
        """Build a grouped config from the flat kwargs."""
        if page_size is not None:
            paging = PagingConfig(page_size=int(page_size), n_pages=n_pages,
                                  prefix_reuse=prefix_reuse)
        else:
            if n_pages is not None:
                raise ValueError("n_pages requires page_size (paged mode)")
            paging = None
        return cls(
            max_batch=int(max_batch), max_seq=int(max_seq),
            prompt_bucket_min=int(prompt_bucket_min),
            prompt_cap=prompt_cap, start_version=int(start_version),
            decode_kernel=decode_kernel,
            sampling=SamplingConfig(temperature=temperature, top_k=top_k,
                                    sample_seed=sample_seed),
            backpressure=BackpressureConfig(
                max_queue=max_queue, shed_policy=shed_policy,
                admission_deadline=admission_deadline),
            paging=paging, speculative=speculative)
