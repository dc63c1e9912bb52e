"""IQ exporter — stream a VFO's IF baseband (or the wideband) over TCP
(counterpart of sdrplusplusbrown_tpu/modules/iq_exporter.py; host code on
the app's host copies: the baseband event's numpy block, a radio's audio
event).

reference: misc_modules/iq_exporter — exports IQ as int8/int16/float32
over a network socket for external decoders.  Each client connection
receives a stream of [u32 type][u32 size] framed sample packets
(reusing the server protocol's framing and quantizer).
"""

from __future__ import annotations

import socket
import threading
from typing import Dict

import numpy as np

from ..app import ModuleInstance, RadioModuleInstance
from ..ops.compression import PCMType, compress_samples
from ..server.protocol import PacketType, pack_packet
from ..utils.flog import flog


class IQExporterModule(ModuleInstance):
    def __init__(self, name: str, app, port: int = 0,
                 mode: str = "baseband", stream: str = "Radio",
                 pcm: str = "i16"):
        super().__init__(name)
        self.app = app
        self.mode = mode          # baseband | audio
        self.stream = stream
        self.pcm = {"f32": PCMType.F32, "i16": PCMType.I16,
                    "i8": PCMType.I8}[pcm]
        self._clients: Dict[int, socket.socket] = {}
        self._next = 0
        self._mtx = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", port))
        self._listener.listen(4)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True).start()
        if mode == "baseband":
            app.baseband_event.bind(self._on_samples)
        else:
            m = app.modules.get(stream)
            if isinstance(m, RadioModuleInstance):
                m.audio_event.bind(self._on_audio)
        flog.info("iq_exporter[{}] on port {} ({})", name, self.port, mode)

    def module_type(self) -> str:
        return "iq_exporter"

    def _accept(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            with self._mtx:
                self._clients[self._next] = sock
                self._next += 1

    def _send(self, payload: bytes):
        pkt = pack_packet(PacketType.BASEBAND, payload)
        with self._mtx:
            dead = []
            for cid, sock in self._clients.items():
                try:
                    sock.sendall(pkt)
                except OSError:
                    dead.append(cid)
            for cid in dead:
                self._clients.pop(cid).close()

    def _on_samples(self, iq: np.ndarray):
        if self._clients:
            self._send(compress_samples(iq, self.pcm))

    def _on_audio(self, audio: np.ndarray):
        if self._clients:
            z = (audio[0] + 1j * audio[1]).astype(np.complex64) \
                if audio.ndim == 2 else audio.astype(np.complex64)
            self._send(compress_samples(z, self.pcm))

    def shutdown(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._mtx:
            for s in self._clients.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._clients.clear()

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "status":
            with self._mtx:
                return {"port": self.port, "mode": self.mode,
                        "clients": len(self._clients)}
        return super().handle_debug_command(cmd, args)
