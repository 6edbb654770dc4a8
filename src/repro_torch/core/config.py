"""Training configuration (port of ``repro.core.config``): the grouped
constructor argument of ``MasterEventLoop``.

  DeadlineConfig    deadline_quantile / deadline_slack (partial
                    participation)
  PublishConfig     publish_every / publish_fn (hand post-step params to
                    a consumer every N iterations)
  GuardrailConfig   the NaN/divergence watchdog knobs (from
                    core/guardrails.py)

``TrainingConfig`` also carries ``hierarchy``; the port has no two-tier
hierarchy yet, so a non-``None`` value raises ``NotImplementedError``
naming ROADMAP A5. All validation happens at construction and names the
offending value.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.core.guardrails import GuardrailConfig, TrainingGuardrails

PyTree = Any


@dataclass(frozen=True)
class DeadlineConfig:
    """Deadline-based partial participation: when ``quantile`` is set, each
    iteration closes at ``scheduler.deadline(live, quantile, slack)``;
    replies landing later are excluded from the reduce and their mass
    parks in the worker's error-feedback residual. ``quantile=None`` =
    stall-on-slowest (the paper's behavior)."""
    quantile: Optional[float] = None
    slack: float = 1.5

    def __post_init__(self):
        if self.quantile is not None and not 0.0 < self.quantile <= 1.0:
            raise ValueError(
                f"deadline_quantile={self.quantile} must lie in (0, 1]")
        if self.slack <= 0.0:
            raise ValueError(
                f"deadline_slack={self.slack} must be positive")


@dataclass(frozen=True, eq=False)   # eq=False: fn is a callable
class PublishConfig:
    """Every ``every`` iterations the loop hands its post-step params to
    ``fn(params, version, clock)``. ``every=0`` disables publishing."""
    every: int = 0
    fn: Optional[Callable[[PyTree, int, float], None]] = None

    def __post_init__(self):
        if self.every < 0:
            raise ValueError(
                f"publish_every={self.every} must be >= 0 (0 disables)")


@dataclass(frozen=True, eq=False)   # eq=False: guardrails/fn members
class TrainingConfig:
    """Everything ``MasterEventLoop`` needs beyond its live components
    (reducer/cluster/scheduler/allocator/frac_controller).

    ``guardrails`` accepts either the frozen ``GuardrailConfig`` knobs
    (the loop builds its own ``TrainingGuardrails``) or an existing
    ``TrainingGuardrails`` instance (callers that inspect watchdog state
    afterwards keep their handle)."""
    T: float = 4.0
    deadline: DeadlineConfig = field(default_factory=DeadlineConfig)
    publish: PublishConfig = field(default_factory=PublishConfig)
    guardrails: Optional[Any] = None    # GuardrailConfig | TrainingGuardrails
    hierarchy: Optional[Any] = None

    def __post_init__(self):
        if self.T <= 0.0:
            raise ValueError(f"T={self.T} must be positive (the iteration "
                             f"budget in seconds)")
        if self.guardrails is not None and not isinstance(
                self.guardrails, (GuardrailConfig, TrainingGuardrails)):
            raise ValueError(
                f"guardrails={self.guardrails!r}: expected GuardrailConfig "
                f"or TrainingGuardrails")
        if self.hierarchy is not None:
            raise NotImplementedError(
                "the two-tier sub-master hierarchy is not ported yet "
                "(ROADMAP A5)")

    def resolve_guardrails(self) -> Optional[TrainingGuardrails]:
        """The live watchdog instance this config asks for (None = trust
        every message, the paper's behavior)."""
        if self.guardrails is None:
            return None
        if isinstance(self.guardrails, TrainingGuardrails):
            return self.guardrails
        return TrainingGuardrails(self.guardrails)

    @classmethod
    def from_flat(cls, *, T: float = 4.0,
                  deadline_quantile: Optional[float] = None,
                  deadline_slack: float = 1.5,
                  publish_every: int = 0,
                  publish_fn: Optional[Callable] = None,
                  guardrails: Optional[Any] = None,
                  hierarchy: Optional[Any] = None
                  ) -> "TrainingConfig":
        """Build a grouped config from the historical flat kwargs."""
        return cls(
            T=float(T),
            deadline=DeadlineConfig(quantile=deadline_quantile,
                                    slack=deadline_slack),
            publish=PublishConfig(every=int(publish_every), fn=publish_fn),
            guardrails=guardrails, hierarchy=hierarchy)
