"""Per-phase timers — the PetscLogEvent analog.

The reference wraps every sub-solver of the coupled ml_model in
``PetscLogEventRegister/Begin/End`` pairs
(``driver/standalone/ml_model/ml_model_problem.F90:323-336,377-409``)
so ``-log_view`` reports per-phase counts and times.  Here each phase
is a named accumulator; on the device the scopes also surface in the
JAX profiler timeline via ``jax.profiler.TraceAnnotation``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        try:
            from jax.profiler import TraceAnnotation
            ann = TraceAnnotation(name)
        except Exception:           # profiler unavailable (e.g. stub jax)
            ann = None
        t0 = time.perf_counter()
        if ann is not None:
            ann.__enter__()
        try:
            yield
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        """{phase: {count, total_s, mean_s}} — the -log_view analog."""
        return {name: {"count": self._count[name],
                       "total_s": self._acc[name],
                       "mean_s": self._acc[name] / self._count[name]}
                for name in self._acc}

    def __str__(self):
        lines = ["Phase           Count   Total(s)    Mean(s)"]
        for name, s in sorted(self.report().items()):
            lines.append(f"{name:<15} {s['count']:>5} {s['total_s']:>10.4f} "
                         f"{s['mean_s']:>10.4f}")
        return "\n".join(lines)
