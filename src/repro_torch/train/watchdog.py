"""Step-time straggler watchdog.

The port's own copy of ``repro/train/watchdog.py`` (plain Python).

The watchdog tracks an EMA of step time; a step exceeding
``ema * slow_factor`` is flagged *slow* (telemetry / reassignment policy
hook), and one exceeding ``hang_timeout`` seconds triggers the restart
policy (the driver rolls back to the last checkpoint, see
``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Watchdog:
    slow_factor: float = 3.0
    hang_timeout: float = 300.0
    ema_decay: float = 0.9
    ema: float | None = None
    slow_steps: int = 0
    _t0: float | None = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> dict:
        dt = time.monotonic() - self._t0
        slow = False
        if self.ema is not None and dt > self.ema * self.slow_factor:
            slow = True
            self.slow_steps += 1
        self.ema = dt if self.ema is None else (
            self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        )
        return {"step_time": dt, "slow": slow, "ema": self.ema}

    def hung(self) -> bool:
        return self._t0 is not None and (
            time.monotonic() - self._t0 > self.hang_timeout
        )
