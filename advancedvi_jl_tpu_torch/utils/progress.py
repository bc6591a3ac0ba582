"""Live progress meter streaming the merged per-iteration info (port of
utils/progress.py).

Reference parity: the reference pushes every iteration's merged info
NamedTuple to a ProgressMeter line (``pm_next!`` shows all values,
reference utils.jl:2-4; meter configured with showspeed at the
reference's optimize.jl:52-54).  Here the meter renders ONE updating line
(carriage-return, no scroll) on stderr:

    37%|███████             | 3700/10000 [2.1s, 1761 it/s] elbo=-104.23 epoch=4

Every scalar entry of the info dict is displayed (floats compact, bools
as-is), so algorithm extras (epoch, covweighted_fisher, ...) and callback
extras appear automatically — the merged-info contract of the reference.
Rendering is time-throttled (default 10 Hz) so the meter never becomes
the bottleneck of a host-loop run.

Pass a custom instance via ``optimize(..., progress=ProgressMeter(...))``
(mirrors the reference's ``progress`` kwarg) e.g. to redirect the stream;
``show_progress=True`` constructs a default one.  ``optimize`` updates it
at each chunk's one host read, so the meter adds no wait for the device.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Optional

import numpy as np
import torch

_SKIP_KEYS = ("iteration", "terminate", "diverged")
_BAR_WIDTH = 20


def _fmt_value(v: Any) -> Optional[str]:
    """Compact scalar formatting; None for non-scalars."""
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    try:
        arr = np.asarray(v)
    except Exception:
        return None
    if arr.ndim != 0:
        return None
    if arr.dtype.kind in "iub":
        return str(arr.item())
    if arr.dtype.kind == "f":
        return f"{arr.item():.6g}"
    return None


class ProgressMeter:
    """Single-line live progress display.

    ``update(iteration, info)`` renders (throttled); ``close()`` renders a
    final line and terminates it with a newline.  No-ops gracefully on
    non-tty streams except that lines still end up in the stream (tests
    capture them via a StringIO).
    """

    def __init__(
        self,
        max_iter: int,
        stream: Any = None,
        min_interval_s: float = 0.1,
    ):
        self.max_iter = max_iter
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval_s = min_interval_s
        self._t0 = time.time()
        self._last_render = 0.0
        self._closed = False

    def render(self, iteration: int, info: dict) -> str:
        frac = min(1.0, iteration / self.max_iter) if self.max_iter else 1.0
        filled = int(round(frac * _BAR_WIDTH))
        bar = "█" * filled + " " * (_BAR_WIDTH - filled)
        dt = max(time.time() - self._t0, 1e-9)
        speed = iteration / dt
        parts = [
            f"{frac * 100:3.0f}%|{bar}| {iteration}/{self.max_iter}",
            f"[{dt:.1f}s, {speed:.0f} it/s]",
        ]
        for k, v in info.items():
            if k in _SKIP_KEYS:
                continue
            s = _fmt_value(v)
            if s is not None:
                parts.append(f"{k}={s}")
        return " ".join(parts)

    def update(self, iteration: int, info: dict, force: bool = False) -> None:
        if self._closed:
            return
        now = time.time()
        final = iteration >= self.max_iter
        if not (force or final) and now - self._last_render < self.min_interval_s:
            return
        self._last_render = now
        try:
            self.stream.write("\r" + self.render(iteration, info))
            self.stream.flush()
        except Exception:
            self._closed = True  # never let display errors kill a run

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.stream.write("\n")
            self.stream.flush()
        except Exception:
            pass
        self._closed = True
