"""KiwiSDR network source: 12 kHz IQ from a remote KiwiSDR receiver (a copy
of sdrplusplusbrown_tpu/io/kiwisdr_source.py; host code, the same bytes on
the wire).

reference: source_modules/kiwisdr_source/src/main.cpp — registers
"kiwisdr" with the SourceManager at a fixed 12 kHz input rate
(main.cpp:115), tunes by sending ``SET mod=iq`` over the kiwi WebSocket
dialect (main.cpp:234-238 → core/src/utils/proto/kiwisdr.h:193-199),
and converts the 512-pair s16be SND payloads to complex float.  The
WS/protocol layer is shared with websdr_view (`server/kiwisdr.py`).
"""

from __future__ import annotations

import numpy as np

from .network_source import _QueueSource
from ..server.kiwisdr import KiwiSDRClient, IQDATA_FREQUENCY


class KiwiSDRSource(_QueueSource):
    """Remote KiwiSDR as a SourceManager source (IQ mode)."""

    name = "KiwiSDR"
    samplerate_fixed = float(IQDATA_FREQUENCY)   # main.cpp:115

    def __init__(self, host: str, port: int = 8073,
                 freq_hz: float = 14_100_000.0):
        super().__init__(self.samplerate_fixed)
        self.client = KiwiSDRClient(host, port,
                                    freq_khz=float(freq_hz) / 1000.0,
                                    mode="iq", on_iq=self._push)
        self.client.start()

    def tune(self, freq_hz: float):
        self.client.tune(freq_hz)

    @property
    def status(self) -> str:
        return self.client.status

    def close(self):
        self.client.stop()
        super().close()
