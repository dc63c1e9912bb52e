"""Source registry: named source providers with select/start/stop/tune (a
copy of sdrplusplusbrown_tpu/io/source_manager.py; host code).

reference: core/src/signal_path/source.{h,cpp} — sources register by
name, the manager routes select/start/stop/tune to the selected one and
falls back to a null source when the selected source unregisters
(source.cpp:60-75).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ..utils.event import Event
from ..utils.flog import flog


class NullSource:
    """Zeros at the configured rate (the fallback source)."""

    def __init__(self, samplerate: float = 1_000_000.0,
                 realtime: bool = True):
        self.samplerate = float(samplerate)
        self.realtime = realtime

    def blocks(self) -> Iterator[np.ndarray]:
        B = max(int(self.samplerate // 200), 1024)
        while True:
            if self.realtime:
                time.sleep(B / self.samplerate)
            yield np.zeros(B, np.complex64)


class SourceManager:
    def __init__(self):
        self._providers: Dict[str, Callable] = {}
        self.selected: Optional[str] = None
        self.source = None
        self.tuned_hz = 0.0
        self.on_tune: Event = Event()
        self.on_select: Event = Event()

    def register(self, name: str, factory: Callable):
        """factory(**config) -> source object with .samplerate/.blocks()"""
        self._providers[name] = factory

    def unregister(self, name: str):
        self._providers.pop(name, None)
        if self.selected == name:
            # fall back to the null source (reference source.cpp:60-75)
            sr = getattr(self.source, "samplerate", 1_000_000.0)
            flog.warn("source '{}' unregistered — null source fallback",
                      name)
            self.selected = None
            self.source = NullSource(sr)

    def names(self):
        return sorted(self._providers)

    def select(self, name: str, **config) -> bool:
        f = self._providers.get(name)
        if f is None:
            return False
        self.source = f(**config)
        self.selected = name
        self.on_select.emit(name)
        return True

    def tune(self, freq_hz: float):
        self.tuned_hz = float(freq_hz)
        tuner = getattr(self.source, "tune", None)
        if callable(tuner):
            tuner(freq_hz)
        self.on_tune.emit(freq_hz)

    def blocks(self):
        src = self.source or NullSource()
        return src.blocks()
