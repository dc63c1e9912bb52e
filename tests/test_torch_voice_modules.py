"""The voice and trunking module types on the port's app (``device="cpu"``)
against the JAX app's, from one config.json each, fed the same small
synthetic captures through their baseband handlers (``chip_smoke.py``'s
generators, as its phase 31 makes them at 2.4 MS/s): a DMR base station
(a voice superframe, data bursts with a standard RS(12,9) voice header
and terminator, a CSBK, the CACH's short LC), a P25 station (LDU1s, a
TSDU with NET_STS_BCST, a TSDU whose first block is bad and whose second
is an IDEN_UP with a negative offset) and a D-STAR station, each an
``ch_extravhf_decoder`` at 96 kS/s; the TETRA downlink through
``ch_tetra_demodulator`` at 72 kS/s (a BSCH and a MAC-RESOURCE: the
module's call is one RxVFO granule, 2 samples there, so a short capture)
and at 2.4 MS/s (the whole fragmented SDS: 12 symbols a call); the P25
module's NID products over HTTP from the port's entry point, as
tests/test_e2e_synthetic_digital.py gets the JAX app's; and the
host-side pieces of phase 31 on plain versions.

Tolerances: the status dicts equal the JAX app's, but in the places a
fix of the port applies, each asserted: the DMR full LC (RS(12,9): the
port decodes the standard header and terminator, the JAX package
neither) and the P25 TSBKs (``parse_tsdu`` past the bad block: the port
reads the IDEN_UP as -1.0 MHz, the JAX package never sees it).
"""

import json
import os

import numpy as np
import pytest

from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu_torch.app import SDRApp

from torch_parity import _chip_smoke

SMOKE = _chip_smoke()


def _apps(tmp_path, sr: float, modules: dict):
    config = {"source": {"type": "none", "samplerate": sr},
              "fftSize": 4096, "modules": modules}
    apps = []
    for name, cls, kw in (("jax", JaxApp, {}), ("port", SDRApp,
                                                {"device": "cpu"})):
        root = tmp_path / name
        os.makedirs(root, exist_ok=True)
        with open(root / "config.json", "w") as f:
            json.dump(config, f)
        apps.append(cls(str(root), run_pump=False, **kw))
    return apps


def _statuses(tmp_path, sr, modules, x, chunk, script=()):
    """Both apps' modules fed ``x`` in chunks of ``chunk`` samples (each
    chunk to every module in turn), then every module's status and the
    replies to ``script``: [jax, port], each {module: (status, replies)}."""
    apps = _apps(tmp_path, sr, modules)
    try:
        out = []
        for app in apps:
            for i in range(0, len(x), chunk):
                for m in app.modules.values():
                    m._on_baseband(x[i:i + chunk])
            out.append({n: (json.loads(json.dumps(
                m.handle_debug_command("status", ""))),
                [m.handle_debug_command(c, a) for c, a in script])
                for n, m in app.modules.items()})
        return out
    finally:
        for app in apps:
            app.shutdown()


def _less(d: dict, keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


@pytest.fixture(scope="module")
def extravhf_96k(tmp_path_factory):
    fs = 96_000.0
    ch = {"DMR": -30e3, "P25": -10e3, "DSTAR": 15e3}
    x = SMOKE.voice_capture(None, fs=fs, channels=ch)["iq"]
    return _statuses(tmp_path_factory.mktemp("vhf"), fs, {
        n: {"type": "ch_extravhf_decoder", "offset": o}
        for n, o in ch.items()}, x, 4800,
        script=[("set_offset", "1000"), ("bogus", "")])


def test_dmr_module(extravhf_96k):
    jax, port = (s["DMR"] for s in extravhf_96k)
    assert jax[1] == port[1]
    fixed = ("fullLcDecodes", "lastFullLC")
    assert _less(jax[0], fixed) == _less(port[0], fixed)
    s = port[0]
    assert (s["lastLC"]["dst"], s["lastLC"]["src"]) == SMOKE.VO_DMR_LC
    assert s["colorCode"] == SMOKE.VO_DMR_CC
    assert s["lastShortLC"] == {"opcode": 1, "data": 0x00AB12}
    assert s["lastCSBK"]["csbkoName"] == "BS_Dwn_Act"
    assert s["burstTypes"]["VOICE Header"] == 1
    # the fix: the standard RS(12,9) header and terminator decode in the
    # port only
    assert s["fullLcDecodes"] == 2 and jax[0]["fullLcDecodes"] == 0
    assert (s["lastFullLC"]["dst"], s["lastFullLC"]["src"]) == \
        SMOKE.VO_DMR_HDR
    assert jax[0]["lastFullLC"] is None


def test_p25_module(extravhf_96k):
    jax, port = (s["P25"] for s in extravhf_96k)
    fixed = ("tsbkDecodes", "lastTSBK")
    assert _less(jax[0], ("p25",)) == _less(port[0], ("p25",))
    assert _less(jax[0]["p25"], fixed) == _less(port[0]["p25"], fixed)
    p, j = port[0]["p25"], jax[0]["p25"]
    assert p["nac"] == SMOKE.VO_P25_NAC
    assert (p["lastLC"]["talkgroup"], p["lastLC"]["src"]) == SMOKE.VO_P25_LC
    assert p["duidCounts"]["TSDU"] == 2
    # the fix: the second TSDU's IDEN_UP past its bad first block
    assert (p["tsbkDecodes"], j["tsbkDecodes"]) == (3, 2)
    assert p["lastTSBK"]["opcodeName"] == "IDEN_UP"
    assert p["lastTSBK"]["txOffsetMhz"] == pytest.approx(-1.0)
    assert j["lastTSBK"]["opcodeName"] == "NET_STS_BCST"
    assert (j["lastTSBK"]["wacn"], j["lastTSBK"]["sysId"]) == \
        SMOKE.VO_P25_NET


def test_dstar_module(extravhf_96k):
    jax, port = (s["DSTAR"] for s in extravhf_96k)
    assert jax == port
    d = port[0]["dstar"]
    assert d["headerCrcOk"] == 2 and d["voiceSyncs"] == 2
    h = d["lastHeader"]
    assert (h["rpt2"], h["rpt1"], h["ur"], h["my"], h["suffix"]) == \
        SMOKE.VO_DSTAR_CALLS


def _tetra(tmp_path, fs, bits, chunk):
    x = SMOKE.pi4_iq(bits, fs)
    n = np.random.default_rng(5).standard_normal((2, len(x)))
    x = (x + 0.005 * (n[0] + 1j * n[1])).astype(np.complex64)
    script = [("sysinfo", ""), ("tm_sdus", ""), ("sync_infos", ""),
              ("set_offset", "0"), ("bogus", "")]
    return _statuses(tmp_path, fs, {"T": {"type": "ch_tetra_demodulator"}},
                     x, chunk, script)


def test_tetra_module_72k(tmp_path):
    """At 72 kS/s (the module's call: 2 samples, half a symbol): a BSCH
    burst between random bits; equal statuses and replies, the cell
    decoded."""
    r = np.random.default_rng(50)
    sds = SMOKE.tetra_sds_bits(r)
    bits = np.concatenate([r.integers(0, 2, 128).astype(np.uint8),
                           sds[:510], r.integers(0, 2, 200).astype(np.uint8)])
    jax, port = (o["T"] for o in _tetra(tmp_path, 72_000.0, bits, 700))
    assert jax == port
    s = port[0]
    assert s["sync_decodes"] == 1 and s["bursts"] == 1
    c = s["cell"]
    assert (c["mcc"], c["mnc"], c["colour"]) == SMOKE.VO_TETRA_CELL


def test_tetra_module_sds(tmp_path):
    """At 2.4 MS/s (phase 31's rate, 12 symbols a call): the fragmented SDS
    reassembled, "HELLO TPU", equal statuses and replies."""
    bits = SMOKE.tetra_downlink_bits(np.random.default_rng(51), 1)
    jax, port = (o["T"] for o in _tetra(tmp_path, 2_400_000.0, bits,
                                        50_000))
    assert jax == port
    s = port[0]
    assert s["sync_decodes"] == 1 and s["tm_sdu_reassembled"] == 1
    t = s["last_tm_sdu"]
    assert bytes.fromhex(t["userData"]) == SMOKE.VO_TETRA_TEXT
    assert t["callingSsi"] == SMOKE.VO_TETRA_SSI


def test_p25_nid_products_over_http(tmp_path):
    """tests/test_e2e_synthetic_digital.py's capture (96 kS/s P25: LDU1s
    with talkgroup 4242 / source 31337, every fourth frame a TSDU with a
    grant and NET_STS_BCST) through the port's entry point with
    ``--device cpu`` and the manual pump: the same products over HTTP."""
    from test_e2e_synthetic_digital import make_p25_capture
    from test_torch_http_e2e import TorchAppContext
    cap = make_p25_capture(tmp_path)
    app = TorchAppContext(str(tmp_path / "root"), {
        "source": {"type": "file", "path": cap, "loop": True},
        "pump": "manual", "fftSize": 2048, "fftRate": 10,
        "modules": {"P25": {"type": "ch_extravhf_decoder", "offset": 0.0}}})
    try:
        assert app.wait_ready(timeout=120), app.log()[-3000:]
        s = {}
        for _ in range(30):
            app.pump_step(10)
            s = app.module_cmd("P25", "status")
            pp = s.get("p25", {})
            if (pp.get("duidCounts", {}).get("LDU1", 0) >= 10
                    and pp.get("tsbkDecodes", 0) >= 6):
                break
        p = s["p25"]
        assert s["counts"]["P25P1"] >= 10, s["counts"]
        assert p["nidOk"] >= 10 and p["nac"] == 0x293, p
        assert p["lastDuid"] in ("LDU1", "TSDU"), p
        assert p["duidCounts"]["LDU1"] >= 10, p
        assert p["lcDecodes"] >= 5, p
        assert (p["lastLC"]["talkgroup"], p["lastLC"]["src"]) == \
            (4242, 31337), p
        assert p["duidCounts"].get("TSDU", 0) >= 3, p
        assert p["tsbkDecodes"] >= 6, p
        assert p["lastTSBK"]["opcodeName"] in ("NET_STS_BCST",
                                               "GRP_V_CH_GRANT"), p
        assert s["familySyncs"]["P25P1"] == s["totalSyncs"], s
    finally:
        assert app.close() == 0


def test_phase31_captured_calls_join(tmp_path):
    """Phase 31 (a)'s join of a module's consecutive loop calls, on the
    plain versions: the DMR module's K13m calls (1 600 samples a 0.1 s
    block at 2.4 MS/s) and the TETRA module's K12c and K13m calls (24
    samples a granule), captured by module (``capture``,
    ``module_calls``), each starting from the state the one before
    returned (``joined_call``), and the joined call's outputs those of
    its pieces."""
    import torch
    fs = 2_400_000.0
    x = SMOKE.voice_capture(None, fs=fs, seconds=0.2, channels={
        "CTCSS": -600e3, "TETRA": 700e3})["iq"]
    root = tmp_path / "p"
    os.makedirs(root)
    with open(root / "config.json", "w") as f:
        json.dump({"source": {"type": "none", "samplerate": fs},
                   "fftSize": 4096, "modules": {
                       "DMR": {"type": "ch_extravhf_decoder",
                               "offset": -600e3},
                       "TETRA": {"type": "ch_tetra_demodulator",
                                 "offset": 700e3}}}, f)
    app = SDRApp(str(root), run_pump=False, device="cpu")
    by_module = {}
    try:
        hs = [SMOKE.module_calls(("K12c", "K13m"), by_module, n,
                                 m._on_baseband)
              for n, m in app.modules.items()]

        def run():
            for i in range(0, len(x), 120_000):
                for h in hs:
                    h(x[i:i + 120_000])
        SMOKE.capture(("K12c", "K13m"), run, suffix="_ref")
    finally:
        app.shutdown()
    dmr = by_module["DMR"]["K13m"]
    assert len(dmr) == 2 and not by_module["DMR"].get("K12c")
    assert [SMOKE.loop_input("K13m", c).shape[1] for c in dmr] == [1600] * 2
    tet = by_module["TETRA"]
    assert len(tet["K12c"]) == len(tet["K13m"]) == 300
    for tag, calls, k in (("K13m", dmr, 2), ("K12c", tet["K12c"][-40:], 40),
                          ("K13m", tet["K13m"][-40:], 40)):
        one = SMOKE.joined_call(tag, calls, k, suffix="_ref")
        fn = getattr(*SMOKE.kernel_fn(tag, "_ref"))
        whole = SMOKE.flat(fn(*one))
        parts = [SMOKE.flat(fn(*c)) for c in calls[:k]]
        if tag == "K12c":
            got = torch.cat([p[0] for p in parts], dim=1)
            assert torch.equal(whole[0], got)
        else:
            # ((symbols, valid), state): the valid symbols, in order
            got = torch.cat([o[0][0][o[0][1]] for o in (
                fn(*c) for c in calls[:k])])
            w = fn(*one)[0]
            assert torch.equal(w[0][w[1]], got)
