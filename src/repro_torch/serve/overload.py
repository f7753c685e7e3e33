"""Brownout ladder for the serving engine's overload response.

Under sustained saturation a serving fleet has three levers, ordered by
how much value each destroys: shrink LOW-priority outputs (cheap — the
request still completes, just shorter), shed queued LOW decode work
(the request finalizes truncated), and finally reject at admission
(the request never runs).  The :class:`OverloadController` walks those
rungs as a *ladder* driven by one scalar load signal — backlog seconds
per live core, from ``SchedulingKernel.backlog_signal()`` — with
per-rung hysteresis so a noisy signal near a threshold does not flap
the fleet between policies.

Rungs::

    0  normal        no intervention
    1  shrink        LOW requests' max_new_tokens clamped to min_tokens
    2  shed          queued LOW decode chains dropped at payload time
    3  reject        non-HIGH admissions refused outright

The controller climbs one rung whenever the signal is at or above that
rung's ``enter`` threshold and descends whenever it falls below the
``exit`` threshold of the rung it is on.  ``exit[i] < enter[i]`` is
enforced so every rung has a hysteresis band.  Transitions are recorded
as ``(t, from_rung, to_rung)`` tuples for ``request_latency_stats()``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
    """Thresholds for the three-rung ladder, in units of the load signal
    (backlog seconds per live core).  ``enter[i]`` raises the controller
    onto rung ``i+1``; ``exit[i]`` lowers it back off.  Both triples must
    be strictly increasing and ``0 < exit[i] < enter[i]`` (hysteresis).

    ``min_tokens`` is the rung-1 clamp: LOW requests admitted while the
    controller sits at rung >= 1 have ``max_new_tokens`` reduced to this
    floor (never below 1)."""
    enter: tuple[float, float, float] = (0.5, 1.5, 4.0)
    exit: tuple[float, float, float] = (0.25, 0.75, 2.0)
    min_tokens: int = 1

    def __post_init__(self) -> None:
        if len(self.enter) != 3 or len(self.exit) != 3:
            raise ValueError("enter/exit must be triples (one per rung)")
        for i in range(3):
            if not (0.0 < self.exit[i] < self.enter[i]):
                raise ValueError(
                    f"rung {i + 1}: need 0 < exit ({self.exit[i]}) < "
                    f"enter ({self.enter[i]}) for hysteresis")
        for i in range(2):
            if self.enter[i] >= self.enter[i + 1]:
                raise ValueError("enter thresholds must be increasing")
            if self.exit[i] >= self.exit[i + 1]:
                raise ValueError("exit thresholds must be increasing")
        if self.min_tokens < 1:
            raise ValueError("min_tokens must be >= 1")


class OverloadController:
    """Hysteresis state machine over :class:`BrownoutConfig`'s rungs.

    ``update(signal, now)`` moves at most as far as the signal justifies
    (it can cross several rungs in one call during a step change) and
    appends one transition tuple per rung crossed in a single update —
    i.e. a jump from 0 to 2 records ``(now, 0, 2)``.  Monotone signal
    ramps therefore produce monotone non-decreasing ``to`` rungs until
    the ramp reverses."""

    def __init__(self, config: BrownoutConfig | None = None) -> None:
        self.config = config or BrownoutConfig()
        self.rung = 0
        self.transitions: list[tuple[float, int, int]] = []

    def update(self, signal: float, now: float) -> int:
        """Fold one load-signal observation in; returns the new rung."""
        cfg = self.config
        start = self.rung
        r = start
        while r < 3 and signal >= cfg.enter[r]:
            r += 1
        if r == start:                      # not climbing: try descending
            while r > 0 and signal < cfg.exit[r - 1]:
                r -= 1
        if r != start:
            self.transitions.append((now, start, r))
            self.rung = r
        return r

    # -- policy queries (read by the serving engine) ------------------------
    @property
    def shrink_low(self) -> bool:
        """Rung >= 1: clamp LOW max_new_tokens to ``config.min_tokens``."""
        return self.rung >= 1

    @property
    def shed_low(self) -> bool:
        """Rung >= 2: drop queued LOW decode chains at payload time."""
        return self.rung >= 2

    @property
    def reject_low(self) -> bool:
        """Rung >= 3: refuse non-HIGH admissions outright."""
        return self.rung >= 3

    def summary(self) -> dict:
        return {
            "rung": self.rung,
            "transitions": len(self.transitions),
            "max_rung": max((to for _, _, to in self.transitions),
                            default=self.rung),
        }
