"""HTTP automation/debug control plane (counterpart of
sdrplusplusbrown_tpu/server/http_server.py; host code, the same routes).

reference: core/src/http_debug_server_impl.cpp:399-763 — the JSON-over-HTTP
surface the whole e2e suite drives: /status, /sdr/{start,stop,status},
/sinks, /streams, /sink/select, /vfo/set_offset, /modules,
/module/<name>/command (GET ?cmd=&args= or POST {"cmd","args"}),
procfs-style /proc and /ls typed get/set endpoints, /log, and /stop.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from ..utils.flog import flog


class ProcRegistry:
    """Typed get/set endpoints any module can register
    (reference http_debug_server_impl.cpp:289-385)."""

    def __init__(self):
        self._entries: Dict[str, Tuple[Callable, Optional[Callable], str]] = {}

    def register(self, path: str, read: Callable[[], str],
                 write: Optional[Callable[[str], None]] = None,
                 type_name: str = "string"):
        self._entries[path.strip("/")] = (read, write, type_name)

    def unregister(self, path: str):
        self._entries.pop(path.strip("/"), None)

    def ls(self):
        return [{"path": p, "type": t, "writable": w is not None}
                for p, (r, w, t) in sorted(self._entries.items())]

    def get(self, path: str):
        e = self._entries.get(path.strip("/"))
        return None if e is None else e[0]()

    def set(self, path: str, value: str) -> bool:
        e = self._entries.get(path.strip("/"))
        if e is None or e[1] is None:
            return False
        e[1](value)
        return True


class HttpDebugServer:
    def __init__(self, app, port: int = 0, host: str = "127.0.0.1",
                 on_exit=None):
        self.app = app
        self.proc = ProcRegistry()
        self.on_exit = on_exit
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, obj, code: int = 200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0) or 0)
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                self._route(self._body())

            def do_POST(self):
                self._route(self._body())

            do_PUT = do_POST

            def _route(self, body: bytes):
                url = urllib.parse.urlparse(self.path)
                path = url.path
                q = dict(urllib.parse.parse_qsl(url.query))
                try:
                    outer._dispatch(self, path, q, body)
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface errors to the client
                    flog.error("http: {} -> {}", path, repr(e))
                    try:
                        self._json({"error": repr(e)}, 500)
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

        # procfs-style endpoints (reference usage:
        # noise_reduction_logmmse/src/main.cpp:54-57, source.cpp:13-48)
        if hasattr(app, "ifnr_enabled"):
            self.proc.register(
                "ifnr/enabled", lambda: str(app.ifnr_enabled).lower(),
                lambda v: app.set_ifnr_enabled(
                    v.lower() in ("1", "true", "on")),
                "bool")
            self.proc.register(
                "ifnr/stop_reason",
                lambda: getattr(app, "ifnr_stop_reason", ""))
        if hasattr(app, "frequency"):
            self.proc.register(
                "source/frequency", lambda: str(app.frequency),
                lambda v: app.tune(float(v)), "double")
            self.proc.register(
                "source/samplerate", lambda: str(app.samplerate))

    # ------------------------------------------------------------------
    def _dispatch(self, h, path: str, q: dict, body: bytes):
        app = self.app
        if path in ("/status", "/"):
            h._json(app.status())
            return
        if path == "/sdr/start":
            app.start()
            h._json({"action": "sdr_start"})
            return
        if path == "/sdr/stop":
            app.stop()
            h._json({"action": "sdr_stop"})
            return
        if path == "/sdr/status":
            h._json({"running": app.running,
                     "frequency": app.frequency,
                     "samplerate": app.samplerate,
                     "blocks": app.blocks_processed,
                     "blockLen": getattr(app, "pump_block_len", 0),
                     "input_samples_per_s": round(
                         app.input_tracker.rate(), 1)})
            return
        if path == "/pump/step":
            # manual pump mode: synchronously process N blocks inside
            # this request (the first may build the kernels — the client
            # sets a generous timeout).  Wall-clock-free e2e drive:
            # progress is counted in blocks, not sleeps.
            if not getattr(app, "pump_manual", False):
                h._json({"error": "pump is not in manual mode"})
                return
            try:
                j = json.loads(body or b"{}")
            except json.JSONDecodeError:
                j = {}
            n = int(j.get("blocks", q.get("blocks", 1)))
            done = app.pump_step(n)
            h._json({"status": "ok", "stepped": done,
                     "blocks": app.blocks_processed,
                     "blockLen": getattr(app, "pump_block_len", 0)})
            return
        if path in ("/stop", "/exit"):
            h._json({"status": "exiting"})
            threading.Thread(target=self._shutdown_app, daemon=True).start()
            return
        if path == "/modules":
            h._json({name: {"module": m.module_type(),
                            "enabled": m.is_enabled()}
                     for name, m in app.modules.items()})
            return
        if path == "/sinks":
            h._json({"sinks": sorted(set(
                ["null_audio_sink", "recorder", "network"]))})
            return
        if path == "/streams":
            names = list(app.modules)
            for n in app.stream_registry.names():
                if n not in names:
                    names.append(n)
            h._json({"streams": [
                {"name": name, "sink": app.sink_sel.get(
                    name, "null_audio_sink")}
                for name in names]})
            return
        if path == "/stream/add_substream":
            try:
                j = json.loads(body or b"{}")
            except json.JSONDecodeError:
                h._json({"error": "invalid JSON body"})
                return
            s = app.add_substream(j.get("stream", "Radio"))
            if s is None:
                h._json({"error": "cannot add substream"})
                return
            h._json({"status": "ok", "name": s.name})
            return
        if path == "/sink/select":
            try:
                j = json.loads(body or b"{}")
            except json.JSONDecodeError:
                h._json({"error": "invalid JSON body"})
                return
            stream = j.get("stream", "Radio")
            sink = j.get("sink", "None")
            if stream not in app.modules \
                    and app.stream_registry.get(stream) is None:
                h._json({"error": f"stream '{stream}' not found"})
                return
            extra = {k: v for k, v in j.items()
                     if k not in ("stream", "sink")}
            if not app.select_sink(stream, sink, **extra):
                h._json({"error": f"cannot attach sink to '{stream}'"})
                return
            h._json({"status": "ok", "stream": stream, "sink": sink})
            return
        if path.startswith("/vfo/set_offset"):
            name = q.get("name", "")
            if not name:
                h._json({"error": "name parameter required"})
                return
            offset = float(q.get("offset", "0"))
            if not app.set_vfo_offset(name, offset):
                h._json({"error": f"vfo '{name}' not found"})
                return
            h._json({"status": "ok", "vfo": name, "offset_hz": offset})
            return
        if path.startswith("/module/") and path.endswith("/command"):
            inst = urllib.parse.unquote(path[len("/module/"):-len("/command")])
            m = app.modules.get(inst)
            if m is None:
                h._json({"error": f"instance '{inst}' not found"})
                return
            cmd, args = q.get("cmd", "command"), q.get("args", "")
            if body:
                try:
                    j = json.loads(body)
                    cmd = j.get("cmd", cmd)
                    args = str(j.get("args", args))
                except json.JSONDecodeError:
                    cmd = body.decode(errors="replace")
            h._json(m.handle_debug_command(cmd, args))
            return
        if path == "/ls" or path.startswith("/ls/"):
            h._json({"entries": self.proc.ls()})
            return
        if path.startswith("/proc"):
            sub = path[len("/proc"):].strip("/")
            if not sub:
                h._json({"entries": self.proc.ls()})
                return
            if "value" in q:
                if self.proc.set(sub, q["value"]):
                    h._json({"status": "ok", "path": sub,
                             "value": q["value"]})
                else:
                    h._json({"error": f"cannot write '{sub}'"})
                return
            v = self.proc.get(sub)
            if v is None:
                h._json({"error": f"unknown proc entry '{sub}'"})
            else:
                h._json({"path": sub, "value": v})
            return
        if path == "/log":
            h._json({"log": flog.dump()})
            return
        h._json({"error": f"unknown path {path}"}, 404)

    def _shutdown_app(self):
        self.app.shutdown()
        self.stop()
        if self.on_exit is not None:
            self.on_exit()

    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        flog.info("http debug server on port {}", self.port)

    def stop(self):
        self._server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
