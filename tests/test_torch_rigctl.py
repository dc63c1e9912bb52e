"""rigctl (hamlib CAT control) on the port against the JAX package on the
CPU: the port's ``RigctlServer`` on the port's app and the JAX server on
the JAX app, both built from one config.json with no transmitter, answer
one command script (``F``, ``f``, ``M`` for every ``MODE_MAP`` key,
``m``, ``T 1``, ``t``, ``V``, ``v``, ``s``, ``\\dump_state``, bad
arguments, an unknown command, ``q``) with the same bytes and leave the
same frequency and demod behind; the port's ``RigctlClient`` works
against both servers.  Every socket has a timeout."""

import json
import os
import socket

import pytest

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.server import rigctl as jrig
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.server import rigctl as prig
from sdrplusplusbrown_tpu_torch.server.rigctl_client import RigctlClient

from torch_parity import port_f32_handoff  # noqa: F401

CONFIG = {"source": {"type": "none", "samplerate": 240_000.0},
          "frequency": 14_200_000.0, "fftSize": 4096,
          "modules": {"Radio": {"type": "radio", "demod": "USB",
                                "offset": 0}}}

SCRIPT = (["F 7074000", "f"]
          + [f"M {k} 2400" for k in prig.MODE_MAP] + ["m", "M USB 2700",
                                                      "m"]
          + ["T 1", "t", "T 0", "V VFOA", "v", "s", "\\dump_state",
             "F notanumber", "M WARBLE 1000", "M", "Z", "", "q"])


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    out = {}
    for side, app_cls, mod in (("jax", JaxApp, jrig), ("port", SDRApp,
                                                       prig)):
        root = str(tmp_path_factory.mktemp(side))
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(CONFIG, f)
        kw = {"device": "cpu"} if side == "port" else {}
        app = app_cls(root, run_pump=False, **kw)
        srv = mod.RigctlServer(app, port=0)
        srv.start()
        out[side] = (app, srv)
    yield out
    for app, srv in out.values():
        srv.stop()
        app.shutdown()


def _transcript(port: int) -> bytes:
    """The script in one write; every reply up to the close ``q``
    causes."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.settimeout(10)
        s.sendall(("\n".join(SCRIPT) + "\n").encode())
        got = b""
        while True:
            b = s.recv(65536)
            if not b:
                return got
            got += b


def test_script_replies_equal_to_jax(apps):
    assert prig.MODE_MAP == jrig.MODE_MAP
    assert prig.MODE_BACK == jrig.MODE_BACK
    assert prig.DUMP_STATE == jrig.DUMP_STATE
    want = _transcript(apps["jax"][1].port)
    got = _transcript(apps["port"][1].port)
    assert got == want
    lines = got.decode().split("\n")
    assert lines[:2] == ["RPRT 0", "7074000.000000"]
    assert lines.count("RPRT -9") == 3       # T 1, T 0 and WARBLE
    assert "RPRT -11" in lines and "RPRT -1" in lines
    for side in ("jax", "port"):
        app = apps[side][0]
        assert app.frequency == 7_074_000.0
        assert app.modules["Radio"].radio.demod_name == "USB"
    assert apps["port"][0].transmitter is None


@pytest.mark.parametrize("side", ["jax", "port"])
def test_port_client_against_both_servers(apps, side):
    app, srv = apps[side]
    cli = RigctlClient("127.0.0.1", srv.port)
    try:
        assert cli.set_frequency(14_074_000)
        assert cli.get_frequency() == 14_074_000.0 == app.frequency
        assert cli.set_mode("LSB", 2700)
        mode, bw = cli.get_mode()
        assert mode == "LSB" and bw > 0
        assert not cli.set_ptt(True)             # no transmitter: RPRT -9
        assert not cli.get_ptt()
        assert cli.set_mode("USB", 2700)
    finally:
        cli.close()
