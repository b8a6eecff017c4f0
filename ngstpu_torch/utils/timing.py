"""Stage timing with the reference's stderr conventions.

The reference prints `Finished at %.3f s` computed as elapsed_microseconds /
CLOCKS_PER_SEC (reference fastq_count.c:100-104,236) — on Linux
CLOCKS_PER_SEC == 1e6 so the figure is seconds. We reproduce the format, and
additionally expose structured per-stage timings for profiling.
"""

from __future__ import annotations

import sys
import time


import os


class StageTimer:
    def __init__(self):
        self.begin = time.monotonic()
        self.stages: list[tuple[str, float]] = []

    def elapsed(self) -> float:
        return time.monotonic() - self.begin

    def log(self, fmt: str = "Finished at %.3f s\n") -> None:
        sys.stderr.write(fmt % self.elapsed())
        if self.stages and os.environ.get("NGSTPU_PROFILE"):
            prev = 0.0
            parts = []
            for name, t in self.stages:
                parts.append(f"{name}={t - prev:.3f}s")
                prev = t
            sys.stderr.write("[profile] " + " ".join(parts) + "\n")

    def checkpoint(self, name: str) -> None:
        self.stages.append((name, self.elapsed()))


class StageRusage:
    """Per-stage wall / user-CPU / system-CPU deltas, dumped as JSON when
    NGSTPU_STAGE_JSON names a path — the stage-isolated evidence channel
    the 10M dedup/sort benchmark embeds in its recorded artifact (same
    role bench_pileup's breakdown plays for the pileup metric)."""

    def __init__(self):
        self.stages: dict[str, dict] = {}
        self._last = self._now()

    @staticmethod
    def _now():
        import resource

        r = resource.getrusage(resource.RUSAGE_SELF)
        return (time.monotonic(), r.ru_utime, r.ru_stime)

    def checkpoint(self, name: str) -> None:
        t, u, s = self._now()
        self.stages[name] = {
            "wall_s": round(t - self._last[0], 3),
            "usr_s": round(u - self._last[1], 3),
            "sys_s": round(s - self._last[2], 3),
        }
        self._last = (t, u, s)

    def dump(self, **extra) -> None:
        path = os.environ.get("NGSTPU_STAGE_JSON")
        if not path:
            return
        import json

        payload = dict(self.stages)
        payload.update(extra)
        try:
            with open(path, "a") as f:
                f.write(json.dumps(payload) + "\n")
        except OSError:
            pass
