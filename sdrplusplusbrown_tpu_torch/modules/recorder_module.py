"""Recorder module — record demod audio or raw baseband to WAV
(counterpart of sdrplusplusbrown_tpu/modules/recorder_module.py).

reference: misc_modules/recorder (677 LoC) — audio mode taps a sink
stream; baseband mode taps the IQ front end; files use the capture-
timestamp naming convention.
"""

from __future__ import annotations

import os
from typing import Optional

from ..app import ModuleInstance, RadioModuleInstance
from ..io.recorder import WavRecorder
from ..utils.flog import flog


class RecorderModule(ModuleInstance):
    def __init__(self, name: str, app, directory: Optional[str] = None):
        super().__init__(name)
        self.app = app
        self.directory = directory or os.path.join(app.root, "recordings")
        self.mode = "audio"              # audio | baseband
        self.rec: Optional[WavRecorder] = None
        self.stream = "Radio"
        self._handler = None

    def module_type(self) -> str:
        return "recorder"

    def start_recording(self, stream: str = "Radio",
                        mode: str = "audio") -> Optional[str]:
        if self.rec is not None:
            return None
        os.makedirs(self.directory, exist_ok=True)
        self.mode = mode
        self.stream = stream
        m = self.app.modules.get(stream)
        if mode == "audio":
            if not isinstance(m, RadioModuleInstance):
                return None
            path = os.path.join(self.directory, WavRecorder.capture_name(
                "audio", self.app.frequency))
            self.rec = WavRecorder(path, m.radio.audio_samplerate,
                                   channels=2)

            def on_audio(a):
                if self.rec is not None:
                    self.rec.write(a)

            self._handler = on_audio
            m.audio_event.bind(on_audio)
        else:
            path = os.path.join(self.directory, WavRecorder.capture_name(
                "baseband", self.app.frequency))
            self.rec = WavRecorder(path, self.app.frontend.effective_sr,
                                   channels=2)
            self.app.baseband_event.bind(self._on_baseband)
        flog.info("recorder[{}]: recording {} to {}", self.name, mode, path)
        return path

    def _on_baseband(self, iq):
        if self.rec is not None:
            self.rec.write(iq)

    def stop_recording(self):
        m = self.app.modules.get(self.stream)
        if self.mode == "audio" and isinstance(m, RadioModuleInstance) \
                and self._handler:
            m.audio_event.unbind(self._handler)
        elif self.mode == "baseband":
            self.app.baseband_event.unbind(self._on_baseband)
        if self.rec is not None:
            self.rec.close()
            self.rec = None

    def shutdown(self):
        self.stop_recording()

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "start":
            parts = [p.strip() for p in args.split(",") if p.strip()]
            stream = parts[0] if parts else "Radio"
            mode = parts[1] if len(parts) > 1 else "audio"
            path = self.start_recording(stream, mode)
            if path is None:
                return {"error": "cannot start recording"}
            return {"status": "ok", "path": path}
        if cmd == "stop":
            self.stop_recording()
            return {"status": "ok"}
        if cmd == "status":
            return {"recording": self.rec is not None, "mode": self.mode,
                    "stream": self.stream}
        return super().handle_debug_command(cmd, args)
