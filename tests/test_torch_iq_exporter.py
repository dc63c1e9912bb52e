"""The IQ exporter module on the port against the JAX package on the CPU.

Both apps are built from one config.json (no source, an NFM radio and
three exporters: the baseband at i16, the baseband at i8, the radio's
audio at f32); the same seeded baseband and audio events produce the same
packets, byte for byte, from each exporter.  Then the port's app with an
exporter in its config, stepping a file source, sends its own baseband:
each packet is that block's i16 framing.  Every socket has a timeout and
every wait a deadline."""

import json
import os
import socket

import numpy as np
import pytest

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.ops.compression import (PCMType,
                                                        compress_samples)
from sdrplusplusbrown_tpu_torch.server.protocol import (PacketType,
                                                        recv_packet)

from torch_parity import (net_capture, net_config, port_f32_handoff,
                          wait_for)  # noqa: F401

EXPORTERS = {
    "BB16": {"type": "iq_exporter", "mode": "baseband", "pcm": "i16"},
    "BB8": {"type": "iq_exporter", "mode": "baseband", "pcm": "i8"},
    "AF": {"type": "iq_exporter", "mode": "audio", "stream": "Radio",
           "pcm": "f32"},
}


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    cfg = net_config({"type": "none", "samplerate": 240_000.0}, **EXPORTERS)
    out = {}
    for side, app_cls in (("jax", JaxApp), ("port", SDRApp)):
        root = str(tmp_path_factory.mktemp(side))
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(cfg, f)
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = app_cls(root, run_pump=False, **kw)
    yield out
    for app in out.values():
        app.shutdown()


def _connect(exp) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", exp.port), timeout=10)
    s.settimeout(10)
    wait_for(lambda: exp.handle_debug_command("status", "")["clients"] >= 1,
             "the exporter never took the client")
    return s


@pytest.mark.parametrize("name", sorted(EXPORTERS))
def test_packets_equal_to_jax(apps, name):
    rng = np.random.default_rng(len(name))
    bbs = [(0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64) for n in (1_200, 12_000, 1)]
    auds = [(0.2 * rng.standard_normal((2, n))).astype(np.float32)
            for n in (2_400, 480)]
    got = {}
    for side, app in apps.items():
        exp = app.modules[name]
        assert exp.module_type() == "iq_exporter"
        sock = _connect(exp)
        try:
            for bb in bbs:
                app.baseband_event.emit(bb)
            for au in auds:
                app.modules["Radio"].audio_event.emit(au)
            k = len(auds) if EXPORTERS[name]["mode"] == "audio" else len(bbs)
            got[side] = [recv_packet(sock) for _ in range(k)]
            st = exp.handle_debug_command("status", "")
            assert st["port"] == exp.port and st["mode"] == \
                EXPORTERS[name]["mode"]
        finally:
            sock.close()
    assert got["port"] == got["jax"]
    assert all(t == PacketType.BASEBAND for t, _ in got["port"])


def test_app_exports_its_own_baseband(tmp_path):
    cap = str(tmp_path / "baseband_14000000Hz_10-00-00_01-01-2024.wav")
    net_capture(cap, seconds=0.25)
    root = str(tmp_path / "root")
    os.makedirs(root)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(net_config({"type": "file", "path": cap, "loop": True},
                             Export=EXPORTERS["BB16"]), f)
    app = SDRApp(root, run_pump=False, device="cpu")
    sent = []
    try:
        exp = app.modules["Export"]
        sock = _connect(exp)
        app.baseband_event.bind(lambda b: sent.append(b.copy()))
        app.start()
        assert app.pump_step(2) == 2
        pkts = [recv_packet(sock) for _ in sent]
        sock.close()
    finally:
        app.shutdown()
    assert len(sent) == 2 and sent[0].shape == (app.pump_block_len,)
    for bb, (ptype, payload) in zip(sent, pkts):
        assert ptype == PacketType.BASEBAND
        assert payload == compress_samples(bb, PCMType.I16)
    assert exp.handle_debug_command("status", "")["clients"] == 0
