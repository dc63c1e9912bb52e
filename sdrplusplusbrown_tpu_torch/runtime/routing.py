"""Stream routing at the host boundary: the fan-out ``Splitter`` and the
priority ``Merger`` the sink layer uses (the part of
sdrplusplusbrown_tpu/runtime/routing.py that runtime/sink.py needs).

reference: core/src/dsp/routing/{splitter,merger}.h.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class Splitter:
    """Fan one host-side stream out to N callbacks (reference
    routing/splitter.h), with bind/unbind semantics."""

    def __init__(self):
        self._outs: List[Callable] = []

    def bind(self, cb: Callable):
        self._outs.append(cb)

    def unbind(self, cb: Callable):
        if cb in self._outs:
            self._outs.remove(cb)

    def push(self, block):
        for cb in list(self._outs):
            cb(block)


class Merger:
    """Priority-preemptive stream merger.

    reference: core/src/dsp/routing/merger.h:35-186 — N bound inputs with
    integer priorities (LOWER number preempts); each emit round picks the
    highest-priority input that has data, drains up to ``chunk`` samples
    from it and DISCARDS what the losing inputs buffered (so a preempted
    stream resumes live, not delayed).  Within ``switch_delay_ms`` of the
    last selection the selected priority is sticky: equal-or-better
    priorities keep the floor even while momentarily empty, so brief gaps
    in the winning stream don't flap the selection (merger.h:114-155).

    ``push`` is called from producer callbacks and ``pull`` from the
    consumer (the app pump), so no threads are needed.  ``time_fn`` is
    injectable for deterministic tests.
    """

    SWITCH_DELAY_MS = 100            # merger.h:114
    CHUNK = 1024                     # merger.h:168

    def __init__(self, time_fn=None):
        import time as _time
        self._time_fn = time_fn or (lambda: _time.monotonic() * 1000.0)
        self._inputs: dict[int, dict] = {}
        self._next_id = 0
        self._last_priority = 0
        self._last_time = -1e18

    def bind(self, priority: int) -> int:
        port = self._next_id
        self._next_id += 1
        self._inputs[port] = {"priority": int(priority), "data": []}
        return port

    def unbind(self, port: int):
        self._inputs.pop(port, None)

    def push(self, port: int, samples: np.ndarray):
        s = self._inputs.get(port)
        if s is not None:
            s["data"].append(np.asarray(samples))

    def _size(self, s) -> int:
        return sum(b.shape[-1] for b in s["data"])

    def pull(self) -> Optional[np.ndarray]:
        """One merge round: the winning input's samples (≤ CHUNK along the
        last axis) or None; losers are flushed."""
        now = self._time_fn()
        best = None
        sticky = (now - self._last_time) < self.SWITCH_DELAY_MS
        for s in self._inputs.values():
            if sticky:
                if s["priority"] <= self._last_priority:
                    best = s
            elif self._size(s) and (best is None
                                    or s["priority"] < best["priority"]):
                best = s
        if best is None or not self._size(best):
            return None
        self._last_priority = best["priority"]
        self._last_time = now
        data = np.concatenate(best["data"], axis=-1)
        out, rest = data[..., :self.CHUNK], data[..., self.CHUNK:]
        best["data"] = [rest] if rest.shape[-1] else []
        for s in self._inputs.values():
            if s is not best:
                s["data"] = []
        return out

    def drain(self) -> List[np.ndarray]:
        """Pull until empty (a full pump-tick's worth)."""
        out = []
        while True:
            blk = self.pull()
            if blk is None:
                return out
            out.append(blk)
