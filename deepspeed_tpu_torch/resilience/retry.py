"""Jittered exponential-backoff retry for checkpoint IO: the JAX package's
``resilience/retry.py``.

Storage writes fail transiently (NFS hiccups, object-store 503s, local disk
pressure); a save that gives up on the first EIO loses the whole step
budget since the last checkpoint. ``retry_io`` wraps the checkpoint
engine's save/load calls; every retry bumps the
``resilience/ckpt_retries`` counter through the caller's ``on_retry`` hook,
so retry storms show in the counters.
"""

import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type

from ..utils.logging import logger

__all__ = ["retry_io", "backoff_delays"]


def backoff_delays(base_delay: float = 0.5, max_delay: float = 8.0,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Endless jittered exponential-backoff schedule: doubling from
    ``base_delay``, capped at ``max_delay``, uniform jitter in
    [0.5x, 1.5x]."""
    rng = rng or random.Random()
    delay = base_delay
    while True:
        yield max(0.0, delay * (0.5 + rng.random()))
        delay = min(max_delay, delay * 2)


def retry_io(fn: Callable, *args,
             attempts: int = 0,
             base_delay: float = 0.5,
             max_delay: float = 8.0,
             retry_on: Tuple[Type[BaseException], ...] = (OSError, IOError),
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             rng: Optional[random.Random] = None,
             label: str = "ckpt_io",
             **kwargs):
    """Call ``fn(*args, **kwargs)``; on a ``retry_on`` failure, retry up to
    ``attempts`` more times with exponential backoff (doubling from
    ``base_delay``, capped at ``max_delay``) and uniform jitter in
    [0.5x, 1.5x]. ``on_retry(retry_index, exc)`` fires before each sleep.
    The final failure re-raises."""
    delays = backoff_delays(base_delay, max_delay, rng)
    for attempt in range(attempts + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if attempt >= attempts:
                raise
            sleep_s = next(delays)
            logger.warning(
                f"{label}: attempt {attempt + 1}/{attempts + 1} failed "
                f"({e}); retrying in {sleep_s:.2f}s")
            if on_retry is not None:
                on_retry(attempt + 1, e)
            if sleep_s:
                time.sleep(sleep_s)
