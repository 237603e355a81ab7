"""Performance clocks and profiler ranges.

Counterpart of ``mom6_tpu.framework.clock``: named nestable wall-clock
timers with call counts, each also a ``torch.profiler.record_function``
range so that the phases show up in a torch.profiler trace.  Kernels
run asynchronously on the card, so a timer that should measure device
work passes ``sync=lambda: x``: when ``x`` (a tensor or a nest of
tensors) lies on the card, the timer calls ``torch.cuda.synchronize()``
before it stops.  Without ``sync`` a timer measures host-side wall time
(launches + Python).

Usage::

    CLOCKS = ClockRegistry()
    with CLOCKS("dynamics"):
        state = step(...)
    print(CLOCKS.report())
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["ClockRegistry", "clock"]


class _Clock:
    __slots__ = ("name", "total", "count", "max")

    def __init__(self, name):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, dt):
        self.total += dt
        self.count += 1
        self.max = max(self.max, dt)


def _on_card(x) -> bool:
    if x is None:
        return False
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_card(v) for v in x)
    # anything else would never synchronize, and the clock would
    # silently report launch time
    raise TypeError(f"clock sync= gave a {type(x).__name__}; give a "
                    "tensor, or a dict, list or tuple of tensors")


class ClockRegistry:
    """Named timers; nesting tracked by a stack for indented reports."""

    def __init__(self):
        self._clocks: dict[str, _Clock] = {}
        self._stack: list[str] = []
        self._depth: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        self._depth.setdefault(name, len(self._stack))
        self._stack.append(name)
        rng = torch.profiler.record_function(name)
        rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
            if sync is not None and _on_card(sync()):
                torch.cuda.synchronize()
        finally:
            dt = time.perf_counter() - t0
            rng.__exit__(None, None, None)
            self._stack.pop()
            self._clocks.setdefault(name, _Clock(name)).add(dt)

    def report(self) -> str:
        """MOM_cpu_clock-style summary: name, calls, total, mean, max."""
        lines = ["%-32s %8s %12s %12s %12s"
                 % ("clock", "calls", "total[s]", "mean[ms]", "max[ms]")]
        for name, c in sorted(self._clocks.items(),
                              key=lambda kv: -kv[1].total):
            pad = "  " * self._depth.get(name, 0)
            mean = c.total / max(c.count, 1)
            lines.append("%-32s %8d %12.3f %12.3f %12.3f"
                         % (pad + name, c.count, c.total, 1e3 * mean,
                            1e3 * c.max))
        return "\n".join(lines) + "\n"

    def reset(self):
        self._clocks.clear()
        self._depth.clear()


# module-level default registry
clock = ClockRegistry()
