"""Power-aware scheduling — MLitB §2.2 "minibursts"; port of
``repro.core.power`` (pure Python, the same arithmetic).

"it is possible for MLitB to manage power intelligently by detecting, for
example, if the device is connected to a power source, its temperature,
and whether it is actively used for other activities. A user might
volunteer periodic 'minibursts' of GPU power towards a learning problem
with minimal disruption."

``PowerPolicy`` scales a worker's compute budget by its reported device
state; ``PowerAwareScheduler`` composes it with the adaptive scheduler so
budget = (T - latency) * duty(state). A phone on battery at high
temperature contributes short minibursts; a plugged, idle workstation
runs the full window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.scheduler import AdaptiveScheduler


@dataclass(frozen=True)
class DeviceState:
    plugged: bool = True
    battery_frac: float = 1.0       # 0..1
    temperature_c: float = 35.0
    user_active: bool = False


@dataclass(frozen=True)
class PowerPolicy:
    min_duty: float = 0.05          # never fully starve a volunteer
    battery_floor: float = 0.2      # below this, minimum duty only
    temp_soft_c: float = 45.0
    temp_hard_c: float = 60.0
    user_active_duty: float = 0.25  # keep the device responsive

    def duty(self, st: DeviceState) -> float:
        d = 1.0
        if not st.plugged:
            if st.battery_frac <= self.battery_floor:
                return self.min_duty
            # linear ramp from floor to full charge
            d *= (st.battery_frac - self.battery_floor) / \
                (1.0 - self.battery_floor)
        if st.temperature_c >= self.temp_hard_c:
            return self.min_duty
        if st.temperature_c > self.temp_soft_c:
            d *= 1.0 - (st.temperature_c - self.temp_soft_c) / \
                (self.temp_hard_c - self.temp_soft_c)
        if st.user_active:
            d = min(d, self.user_active_duty)
        return max(self.min_duty, min(1.0, d))


class PowerAwareScheduler(AdaptiveScheduler):
    """AdaptiveScheduler whose budgets are duty-cycled by device state."""

    def __init__(self, *args, policy: PowerPolicy = PowerPolicy(), **kw):
        super().__init__(*args, **kw)
        self.policy = policy
        self.device_states: Dict[str, DeviceState] = {}

    def report_state(self, worker: str, state: DeviceState) -> None:
        self.device_states[worker] = state

    def budget(self, w: str) -> float:
        base = super().budget(w)
        st = self.device_states.get(w)
        if st is None:
            return base
        b = max(self.min_budget, base * self.policy.duty(st))
        self.stats[w].last_budget = b
        return b
