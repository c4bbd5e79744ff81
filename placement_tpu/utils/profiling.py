"""Profiling harness (SURVEY §5.1).

The reference has no custom tracing — observability is RLlib's TensorBoard
output. Here it is ``jax.profiler``: traces capture XLA ops, fusion
boundaries, and device occupancy, viewable in TensorBoard's profile plugin
or Perfetto. Two entry points:

  * ``trace(logdir)`` — context manager; traces everything inside.
  * ``trace_iterations(logdir, first, last)`` — a window predicate used by
    the trainer to trace a few steady-state iterations (skip iteration 1,
    which is compile).

A trace that was asked for and cannot start or stop raises: a run that
silently lacks the profile it was launched to record is a failed run.
"""

from __future__ import annotations

import contextlib
import os

import jax


@contextlib.contextmanager
def trace(logdir: str):  # noqa: annotation (contextmanager generator)
    """``with trace(dir):`` — capture a jax.profiler trace into ``dir``."""
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class trace_iterations:
    """Trace the inclusive iteration window ``[first, last]``.

    Call ``maybe_start(it)`` before an iteration and ``maybe_stop(it)``
    after it; the trace spans iterations ``first..last`` inclusive.
    """

    def __init__(self, logdir: str, first: int = 2, last: int = 3):
        self.logdir = logdir
        self.first = first
        self.last = last
        self._active = False

    def maybe_start(self, iteration: int) -> None:
        if iteration == self.first and not self._active:
            os.makedirs(self.logdir, exist_ok=True)
            jax.profiler.start_trace(self.logdir)
            self._active = True

    def maybe_stop(self, iteration: int) -> None:
        if iteration >= self.last and self._active:
            self._active = False
            jax.profiler.stop_trace()

    def close(self) -> None:
        self.maybe_stop(self.last)
