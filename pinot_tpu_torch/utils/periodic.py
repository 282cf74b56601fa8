"""Periodic task framework.

A copy of `pinot_tpu/utils/periodic.py`; the controller process runs its
retention and the LLC validation round on it. Analog of the reference's `BasePeriodicTask` + `PeriodicTaskScheduler`
(`pinot-core/.../periodictask/`): named tasks on fixed intervals, start/stop lifecycle,
manual `run_once` for deterministic tests (the reference's tests do the same).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class PeriodicTask:
    def __init__(self, name: str, interval_s: float, fn: Callable[[], None],
                 initial_delay_s: float = 0.0):
        self.name = name
        self.interval_s = interval_s
        self.fn = fn
        self.initial_delay_s = initial_delay_s
        self.run_count = 0
        self.error_count = 0
        self.last_error: Optional[BaseException] = None
        self.last_run_ms: Optional[int] = None

    def run_once(self) -> None:
        # exported per run (reference: ControllerMetrics' periodic task meters)
        # so a task that silently fails every tick shows up as a climbing
        # pinot_periodic_task_errors series and a stale last-run gauge when it
        # stops being scheduled at all
        from .metrics import get_registry
        labels = {"task": self.name}
        try:
            self.fn()
            self.last_error = None  # a clean run clears a stale error
            self.run_count += 1
        except BaseException as e:  # periodic tasks never kill the scheduler
            self.last_error = e
            self.run_count += 1
            self.error_count += 1
            get_registry().counter("pinot_periodic_task_errors", labels).inc()
        self.last_run_ms = int(time.time() * 1000)
        get_registry().gauge("pinot_periodic_task_last_run_ts_ms",
                             labels).set(self.last_run_ms)

    def stats(self) -> Dict[str, object]:
        """One task's health for the controller /debug rollup."""
        return {"runCount": self.run_count, "errorCount": self.error_count,
                "lastRunMs": self.last_run_ms, "intervalS": self.interval_s,
                "lastError": (f"{type(self.last_error).__name__}: "
                              f"{self.last_error}"
                              if self.last_error is not None else None)}


class PeriodicTaskScheduler:
    def __init__(self):
        self._tasks: Dict[str, PeriodicTask] = {}
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    def register(self, task: PeriodicTask) -> None:
        self._tasks[task.name] = task

    def task(self, name: str) -> PeriodicTask:
        return self._tasks[name]

    def run_all_once(self) -> None:
        """Deterministic tick for tests."""
        for t in self._tasks.values():
            t.run_once()

    def stats(self) -> Dict[str, Dict[str, object]]:
        """{task name: run/error/last-run rollup} for debug endpoints."""
        return {name: t.stats() for name, t in self._tasks.items()}

    def start(self) -> None:
        self._stop.clear()
        for t in self._tasks.values():
            th = threading.Thread(target=self._loop, args=(t,), daemon=True,
                                  name=f"periodic-{t.name}")
            th.start()
            self._threads.append(th)

    def _loop(self, task: PeriodicTask) -> None:
        if task.initial_delay_s and self._stop.wait(task.initial_delay_s):
            return
        while not self._stop.is_set():
            task.run_once()
            if self._stop.wait(task.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=5)
        self._threads.clear()
