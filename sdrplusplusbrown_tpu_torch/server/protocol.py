"""Streaming protocol framing and constants (a copy of
sdrplusplusbrown_tpu/server/protocol.py; host code).

Capability analog of the reference's TCP protocol
(reference: core/src/server_protocol.h:10-98): typed packets
[u32 type][u32 size][payload], command packets with a u32 command id and a
JSON argument blob (the reference uses packed structs + smgui UI sync;
wire compatibility with the C++ client is a non-goal — the *capabilities*
are: baseband streaming with three compression regimes, PBKDF2 challenge
auth, sample-rate/frequency control, and a 6 kHz TX backchannel).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from enum import IntEnum

MAGIC = 0x0B5A1000          # server_protocol.h:10
TX_WIRE_SAMPLERATE = 6000    # server_protocol.h:11
PASSWORD_SALT = b"sdrpp-brown-ftw"  # server_protocol.h:12


class PacketType(IntEnum):
    COMMAND = 0
    COMMAND_ACK = 1
    BASEBAND = 2
    BASEBAND_COMPRESSED = 3
    VFO = 4
    FFT = 5
    ERROR = 6
    BASEBAND_WITH_METADATA = 0x37
    TRANSMIT_PROGRESS = 0x38
    TRANSMIT_DATA = 0x39
    BASEBAND_EXPERIMENTAL_FFT = 0x3A


class Command(IntEnum):
    GET_UI = 0x00
    UI_ACTION = 0x01
    START = 0x02
    STOP = 0x03
    SET_FREQUENCY = 0x04
    GET_SAMPLERATE = 0x05
    SET_SAMPLE_TYPE = 0x06
    SET_COMPRESSION = 0x07
    TRANSMIT_ACTION = 0x37
    SET_FFTZSTD_COMPRESSION = 0x38
    SET_EFFT_LOSS_RATE = 0x39
    SET_EFFT_MASKED_FREQUENCIES = 0x3B
    SET_SAMPLERATE = 0x80
    SET_TRANSMITTER_SUPPORTED = 0xA1
    SET_TRANSMITTER_NOT_SUPPORTED = 0xA2
    EFFT_NOISE_FIGURE = 0xA3
    SECURE_CHALLENGE = 0xA4
    DISCONNECT = 0xA5


HDR = struct.Struct("<II")


def pack_packet(ptype: int, payload: bytes = b"") -> bytes:
    return HDR.pack(int(ptype), len(payload)) + payload


def pack_command(cmd: int, args: dict | None = None) -> bytes:
    blob = json.dumps(args or {}).encode()
    return pack_packet(PacketType.COMMAND,
                       struct.pack("<I", int(cmd)) + blob)


def unpack_command(payload: bytes):
    (cmd,) = struct.unpack("<I", payload[:4])
    args = json.loads(payload[4:].decode() or "{}")
    return cmd, args


def recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n > 0:
        b = sock.recv(n)
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_packet(sock):
    hdr = recv_exact(sock, HDR.size)
    ptype, size = HDR.unpack(hdr)
    payload = recv_exact(sock, size) if size else b""
    return ptype, payload


def make_challenge() -> bytes:
    return os.urandom(32)


def sign_challenge(password: str, challenge: bytes) -> bytes:
    """PBKDF2-SHA256 challenge response (reference server.cpp:91-97,
    utils/pbkdf2_sha256.h)."""
    key = hashlib.pbkdf2_hmac("sha256", password.encode(),
                              PASSWORD_SALT, 10_000, dklen=32)
    return hashlib.pbkdf2_hmac("sha256", key, challenge, 1, dklen=32)
