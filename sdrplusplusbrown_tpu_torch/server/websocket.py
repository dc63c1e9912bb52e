"""Minimal RFC6455 WebSocket server transport (stdlib only) (a copy of
sdrplusplusbrown_tpu/server/websocket.py; host code, the same bytes on the
wire).

reference: misc_modules/tci_server/src/websocket.h — the reference
vendors a single-header WS implementation; this is an original compact
server-side implementation (handshake, frame parse/build, ping/pong,
close) sufficient for the TCI dialect.
"""

from __future__ import annotations

import base64
import hashlib
import socket
import struct
import threading
from typing import Callable, Optional

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def _accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()).decode()


def build_frame(opcode: int, payload: bytes) -> bytes:
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


class WSConnection:
    """One accepted, handshaken client connection."""

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self._send_lock = threading.Lock()
        self.open = True
        self.user_data: dict = {}

    def send_text(self, text: str):
        self._send(OP_TEXT, text.encode())

    def send_binary(self, payload: bytes):
        self._send(OP_BINARY, payload)

    def _send(self, opcode: int, payload: bytes):
        if not self.open:
            return
        try:
            with self._send_lock:
                self.sock.sendall(build_frame(opcode, payload))
        except OSError:
            self.open = False

    def close(self):
        if self.open:
            try:
                with self._send_lock:
                    self.sock.sendall(build_frame(OP_CLOSE, b""))
            except OSError:
                pass
        self.open = False
        try:
            self.sock.close()
        except OSError:
            pass

    # -- receive loop ---------------------------------------------------
    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def read_message(self) -> Optional[tuple]:
        """→ (opcode, payload) of the next complete message, or None."""
        opcode = None
        data = b""
        while True:
            hdr = self._read_exact(2)
            if hdr is None:
                return None
            fin = bool(hdr[0] & 0x80)
            op = hdr[0] & 0x0F
            masked = bool(hdr[1] & 0x80)
            n = hdr[1] & 0x7F
            if n == 126:
                ext = self._read_exact(2)
                if ext is None:
                    return None
                n = struct.unpack(">H", ext)[0]
            elif n == 127:
                ext = self._read_exact(8)
                if ext is None:
                    return None
                n = struct.unpack(">Q", ext)[0]
            mask = self._read_exact(4) if masked else b"\x00" * 4
            if mask is None:
                return None
            payload = self._read_exact(n) if n else b""
            if payload is None:
                return None
            if masked:
                payload = bytes(b ^ mask[i % 4]
                                for i, b in enumerate(payload))
            if op == OP_PING:
                self._send(OP_PONG, payload)
                continue
            if op == OP_CLOSE:
                self.close()
                return None
            if op != OP_CONT:
                opcode = op
            data += payload
            if fin:
                return opcode, data


class WebSocketServer:
    """accept → handshake → per-connection reader thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 on_connect: Optional[Callable] = None,
                 on_message: Optional[Callable] = None,
                 on_disconnect: Optional[Callable] = None):
        self.on_connect = on_connect
        self.on_message = on_message
        self.on_disconnect = on_disconnect
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self.port = self._listener.getsockname()[1]
        self.connections: list[WSConnection] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(sock, addr),
                             daemon=True).start()

    def _handle(self, sock: socket.socket, addr):
        # HTTP upgrade handshake
        try:
            req = b""
            while b"\r\n\r\n" not in req:
                chunk = sock.recv(4096)
                if not chunk:
                    return
                req += chunk
            headers = {}
            for line in req.decode(errors="replace").split("\r\n")[1:]:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            key = headers.get("sec-websocket-key")
            if not key:
                sock.close()
                return
            resp = ("HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {_accept_key(key)}\r\n\r\n")
            sock.sendall(resp.encode())
        except OSError:
            return
        conn = WSConnection(sock, addr)
        with self._lock:
            self.connections.append(conn)
        if self.on_connect:
            self.on_connect(conn)
        while conn.open and not self._stop.is_set():
            msg = conn.read_message()
            if msg is None:
                break
            if self.on_message:
                self.on_message(conn, *msg)
        conn.open = False
        with self._lock:
            if conn in self.connections:
                self.connections.remove(conn)
        if self.on_disconnect:
            self.on_disconnect(conn)

    def close(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self.connections)
        for c in conns:
            c.close()
