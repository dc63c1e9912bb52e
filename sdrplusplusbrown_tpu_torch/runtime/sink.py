"""Sink layer: per-module audio streams with volume, a priority merger,
secondary substreams, and the StreamHook observation bus (a copy of
sdrplusplusbrown_tpu/runtime/sink.py; host code on numpy audio).

reference: core/src/signal_path/sink.h —
  * Stream (sink.h:30-92): input → Merger (TX/tone injection preempts
    demod audio) → volume → splitter fan-out to bound consumers + the
    selected sink provider.
  * secondary substreams ``name__##N`` (sink.h:117-135): extra sink
    slots for one module's stream, each with its own sink selection.
  * StreamHook bus (sink.h:195-223): every block of demod audio / raw
    IQ / feedback traffic is published on one Event with source name,
    type, priority and sample rate — how FT8/decoder modules tap audio
    without private wiring.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from .routing import Merger, Splitter
from ..utils.event import Event

SECONDARY_SEP = "__##"          # sink.h:17


def make_secondary_stream_name(name: str, index: int) -> str:
    """reference sink.h:117-123."""
    return name if index == 0 else f"{name}{SECONDARY_SEP}{index}"


def is_secondary_stream(name: str) -> bool:
    return SECONDARY_SEP in name


def get_secondary_stream_index(name: str) -> tuple:
    """→ (base_name, index); reference sink.h:129-135."""
    pos = name.find(SECONDARY_SEP)
    if pos < 0:
        return name, 0
    try:
        return name[:pos], int(name[pos + len(SECONDARY_SEP):])
    except ValueError:
        return name[:pos], 0


@dataclasses.dataclass
class StreamHook:
    """reference sink.h:197-223."""
    SOURCE_DEMOD_OUTPUT = 0
    SOURCE_RAW_RECEIVED_DATA = 1
    SOURCE_FEEDBACK_GENERATOR = 2
    SOURCE_MICROPHONE_OR_DIGI = 3

    source: str
    source_type: int
    priority: int
    samplerate: float
    stereo_data: Optional[np.ndarray] = None   # [2, T]
    iq_data: Optional[np.ndarray] = None       # [T] complex64


# Merger priorities (lower preempts; demod audio is the default input)
PRIO_TX_INJECT = 0
PRIO_TONE = 10
PRIO_DEMOD = 100


class SinkStream:
    """One named audio stream: merger → volume → fan-out.

    Producers: ``push_demod(audio)`` for the module's demodulated audio
    (default priority) and ``inject(priority)->port`` + ``push(port, x)``
    for preempting sources (TX feedback, tone generator).  The consumer
    side is ``bind(cb)`` (reference bindStream, sink.h:168) plus the
    app-selected sink provider.
    """

    def __init__(self, name: str, samplerate: float,
                 time_fn: Optional[Callable] = None):
        self.name = name
        self.samplerate = float(samplerate)
        self.volume = 1.0
        self.muted = False
        self.running = True
        self.merger = Merger(time_fn=time_fn)
        self._demod_port = self.merger.bind(PRIO_DEMOD)
        self.splitter = Splitter()
        self.sr_change: Event = Event()

    # -- producer side -------------------------------------------------
    def push_demod(self, audio: np.ndarray) -> List[np.ndarray]:
        self.merger.push(self._demod_port, audio)
        return self._emit()

    def inject(self, priority: int = PRIO_TX_INJECT) -> int:
        return self.merger.bind(priority)

    def push(self, port: int, audio: np.ndarray) -> List[np.ndarray]:
        self.merger.push(port, audio)
        return self._emit()

    def remove_input(self, port: int):
        self.merger.unbind(port)

    def _emit(self) -> List[np.ndarray]:
        outs = []
        if not self.running:
            return outs
        for blk in self.merger.drain():
            if self.muted:
                blk = np.zeros_like(blk)
            elif self.volume != 1.0:
                blk = blk * self.volume
            self.splitter.push(blk)
            outs.append(blk)
        return outs

    # -- consumer side -------------------------------------------------
    def bind(self, cb: Callable):
        self.splitter.bind(cb)

    def unbind(self, cb: Callable):
        self.splitter.unbind(cb)

    def set_samplerate(self, sr: float):
        self.samplerate = float(sr)
        self.sr_change.emit(sr)


class StreamRegistry:
    """Named SinkStream registry with secondary-substream management
    (the SinkManager stream table, sink.h:236-258)."""

    def __init__(self, time_fn: Optional[Callable] = None):
        self._time_fn = time_fn
        self.streams: Dict[str, SinkStream] = {}
        self.on_stream_registered: Event = Event()
        self.on_stream_unregistered: Event = Event()
        self.on_add_substream: Event = Event()
        self.on_remove_substream: Event = Event()
        #: the StreamHook observation bus (sink.h:222 onStream)
        self.on_stream_data: Event = Event()

    def register(self, name: str, samplerate: float) -> SinkStream:
        if name in self.streams:
            return self.streams[name]
        s = SinkStream(name, samplerate, time_fn=self._time_fn)
        self.streams[name] = s
        self.on_stream_registered.emit(name)
        return s

    def unregister(self, name: str):
        # secondary streams die with their base stream
        base = name
        for n in list(self.streams):
            b, _ = get_secondary_stream_index(n)
            if n == name or b == base:
                self.streams.pop(n, None)
                self.on_stream_unregistered.emit(n)

    def get(self, name: str) -> Optional[SinkStream]:
        return self.streams.get(name)

    def names(self) -> List[str]:
        return sorted(self.streams)

    def add_substream(self, base: str) -> Optional[SinkStream]:
        """Create ``base__##N`` with the next free index ≥ 1."""
        if base not in self.streams or is_secondary_stream(base):
            return None
        idx = 1
        while make_secondary_stream_name(base, idx) in self.streams:
            idx += 1
        name = make_secondary_stream_name(base, idx)
        s = SinkStream(name, self.streams[base].samplerate,
                       time_fn=self._time_fn)
        self.streams[name] = s
        # a substream mirrors its base stream's demod audio
        self.streams[base].bind(
            lambda blk, _s=s: _s.push_demod(blk))
        self.on_add_substream.emit(name)
        return s

    def remove_substream(self, name: str) -> bool:
        if not is_secondary_stream(name) or name not in self.streams:
            return False
        self.streams.pop(name)
        self.on_remove_substream.emit(name)
        return True

    def publish(self, hook: StreamHook):
        """Publish a block on the StreamHook bus."""
        self.on_stream_data.emit(hook)
