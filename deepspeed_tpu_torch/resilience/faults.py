"""Deterministic fault-injection registry: the JAX package's
``resilience/faults.py``.

The checkpoint paths consult this registry at well-known fault points, and
tests arm faults to force the exact failure they want to exercise:

- ``io_write_fail``   — ``MsgpackCheckpointEngine.save`` raises ``OSError``
  before any bytes hit disk (exercises the retry wrapper and the
  commit-before-``latest`` ordering).
- ``io_truncate``     — ``save`` publishes only the first half of the file
  but still records the hash of the whole, modeling a torn write that a
  crash let ``os.replace`` publish (exercises manifest verification and
  fallback).
- ``io_read_corrupt`` — ``load`` flips the first byte of the file
  (exercises load-time corruption handling and tag fallback).

``nan_loss``, ``preempt_signal`` and ``slow_step`` are names the JAX
package's training engine consults (the sentinel, preemption and the
flight recorder, ROADMAP.md row A12); they can be armed here and nothing in
the port fires them yet.

Arming is deterministic and count-based: ``arm(name, times=2, skip=1)``
fires on the 2nd and 3rd hits of the fault point, then disarms itself.
State is process-global (the fault points are in library code); tests
reset it around every test.
"""

import threading
from typing import Dict

__all__ = ["KNOWN_FAULTS", "FaultInjector", "get_injector", "fault"]

KNOWN_FAULTS = frozenset({
    "io_write_fail",
    "io_truncate",
    "io_read_corrupt",
    "nan_loss",
    "preempt_signal",
    "slow_step",
})


class FaultInjector:
    """Count-based arm/fire registry. Thread-safe: checkpoint engines may
    consult fault points from writer threads (nebula)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, Dict[str, int]] = {}
        #: total fires per fault name since the last reset()
        self.fired: Dict[str, int] = {}

    def arm(self, name: str, times: int = 1, skip: int = 0):
        """Arm ``name`` to fire on its next ``times`` hits, after ignoring
        the first ``skip`` hits. Re-arming replaces the previous spec."""
        if name not in KNOWN_FAULTS:
            raise ValueError(
                f"unknown fault {name!r}; known: {sorted(KNOWN_FAULTS)}")
        if times < 1 or skip < 0:
            raise ValueError("arm() requires times >= 1 and skip >= 0")
        with self._lock:
            self._armed[name] = {"times": int(times), "skip": int(skip)}
        return self

    def should_fire(self, name: str) -> bool:
        """Consume one hit of fault point ``name``; True if it fires."""
        with self._lock:
            spec = self._armed.get(name)
            if spec is None:
                return False
            if spec["skip"] > 0:
                spec["skip"] -= 1
                return False
            spec["times"] -= 1
            if spec["times"] <= 0:
                del self._armed[name]
            self.fired[name] = self.fired.get(name, 0) + 1
            return True

    def armed(self, name: str) -> bool:
        with self._lock:
            return name in self._armed

    def reset(self):
        with self._lock:
            self._armed.clear()
            self.fired.clear()
        return self


_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    """The process-global injector all fault points consult."""
    return _INJECTOR


def fault(name: str) -> bool:
    """Convenience for fault points: consume one hit of ``name``."""
    return _INJECTOR.should_fire(name)
