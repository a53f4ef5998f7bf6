"""Failure handling and straggler mitigation for long runs.

The counterpart of `repro.runtime.fault`, pure Python, with the same
defaults.  The failure model: workers die (checkpoint/restart, see
`repro_torch.checkpoint.checkpointer`), workers slow down (stragglers →
deadline-based detection and re-dispatch), and a failing sweep chunk is
retried on a `Backoff` schedule (`repro_torch.core.resilience`).  This
module provides the supervisor loop a multi-host launcher would wrap
around `torch.distributed`, exercised here with simulated failures
(exceptions / injected delays).
"""
from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

log = logging.getLogger("repro_torch.fault")


class NodeFailure(RuntimeError):
    """Raised by a step function when a worker is lost."""


@dataclass(frozen=True)
class Backoff:
    """Exponential-backoff retry schedule: attempt `i` (0-based) sleeps
    `min(base_s * factor**i, cap_s)` before retrying, for up to
    `max_retries` retries after the first attempt.  Shared by the
    resilient sweep executor (`repro_torch.core.resilience`) and any
    supervisor retry loop; `base_s=0` keeps test schedules instant
    while preserving the retry count."""
    base_s: float = 0.05
    factor: float = 2.0
    cap_s: float = 5.0
    max_retries: int = 3

    def delay(self, attempt: int) -> float:
        """Sleep before retry `attempt` (0-based)."""
        return min(self.base_s * self.factor ** attempt, self.cap_s)

    def delays(self):
        """The full schedule, one delay per allowed retry."""
        return [self.delay(i) for i in range(self.max_retries)]

    def sleep(self, attempt: int) -> None:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)


@dataclass
class StragglerPolicy:
    """Deadline-based straggler detection: a step slower than
    `threshold × median` of the trailing window is flagged; after
    `max_flags` consecutive flags the mitigation hook fires (on a real
    fleet: re-dispatch the slow host's shard / drop to checkpoint)."""
    window: int = 16
    threshold: float = 2.5
    max_flags: int = 3
    _times: List[float] = field(default_factory=list)
    _flags: int = 0
    _last_flag_step: int = -2
    events: List[dict] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; True ⇒ fire the mitigation hook.

        "Consecutive" means consecutive *steps*: any fast step — and any
        gap in the observed step sequence (restart, skipped steps) —
        resets the streak, so `max_flags` slow steps scattered over an
        hour never accumulate into a firing.
        """
        self._times.append(seconds)
        self._times = self._times[-self.window:]
        if len(self._times) < 4:
            return False
        med = statistics.median(self._times[:-1])
        slow = seconds > self.threshold * med
        if not slow or step != self._last_flag_step + 1:
            self._flags = 0          # streak broken: fast step or step gap
        if slow:
            self._flags += 1
            self._last_flag_step = step
            self.events.append({"step": step, "seconds": seconds,
                                "median": med})
            if self._flags >= self.max_flags:
                self._flags = 0
                return True
        return False


@dataclass
class Supervisor:
    """Checkpoint/restart supervisor around a step function.

    step_fn(state, step) -> (state, metrics); save_fn(step, state);
    restore_fn() -> (state, step).
    """
    step_fn: Callable
    save_fn: Callable
    restore_fn: Callable
    checkpoint_every: int = 50
    max_restarts: int = 5
    straggler: StragglerPolicy = field(default_factory=StragglerPolicy)
    on_straggler: Optional[Callable] = None
    # zero base delay: restart loops in tests stay instant but still
    # honor the schedule shape when a real deployment raises base_s
    backoff: Backoff = field(default_factory=lambda: Backoff(base_s=0.0))

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        restarts = 0
        history = []
        while step < num_steps:
            try:
                t0 = time.time()
                state, metrics = self.step_fn(state, step)
                dt = time.time() - t0
                if self.straggler.observe(step, dt) and self.on_straggler:
                    self.on_straggler(step)
                history.append(metrics)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(step, state)
            except NodeFailure as e:
                restarts += 1
                log.warning("node failure at step %d (%s); restart %d/%d",
                            step, e, restarts, self.max_restarts)
                if restarts > self.max_restarts:
                    raise
                self.backoff.sleep(restarts - 1)
                state, step = self.restore_fn()
        self.save_fn(step, state)
        return state, step, history, restarts
