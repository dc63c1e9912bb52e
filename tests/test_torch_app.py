"""The served app on the CPU: the port's ``SDRApp`` (manual pump, the
DC blocker on, a file source) against the JAX package's ``SDRApp`` built
from the same config.json and capture.

A seeded 1 MS/s WAV capture carries a stereo FM station (1 kHz tone in L)
at −200 kHz, an NFM carrier (1 kHz tone) at +300 kHz and a DC offset; the
apps run a WFM radio on the station, an NFM radio on the carrier and a
second NFM radio off the signal, squelched at −30 dB, with a recorder on
the WFM radio's stream.  Four blocks, and before the third a retune
(``set_vfo_offset``) and a demod switch (``set_demod``, NFM → USB, with
the carried state migrated): each radio's audio agrees to >= 80 dB in
every block, the squelched radio is exactly zero in both, the spectrum
lines and the waterfall agree by ``assert_spectra_close``, ``vfo_snr``
within 0.01 dB, every carried state leaf (the radios' and the front
end's DC blocker) >= 80 dB after every block and right after the switch,
the status keys are equal, and the recordings have byte-equal headers
and samples >= 80 dB.

The JAX app compiles its steps with ``jax.jit``; for these checks its
steps run op by op (``jax.jit`` replaced by the identity while that app
lives), as the other parity tests call the JAX ``Radio.apply``.  Under
``jax.jit`` XLA fuses the NCO's phase advance into a multiply-add, which
moves the carried phase by about one float32 rounding, and can put it
across the 2π wrap from the port's: ``test_jitted_jax_app_matches``
holds the app as the JAX package runs it, jitted, to the same audio bars
and the NCO phase within 1e-3 rad modulo 2π.

The noise path, on a 240 kS/s capture (``torch_parity.noise_capture``:
USB voice bursts, an NFM carrier, impulses, a DC offset) with a USB and
an NFM radio, in three scripted sessions (``torch_parity.run_noise``):
the IF NR from the config with ``set_afnr logmmse`` on the USB radio and
``set_nb``/``set_fmif`` on the NFM radio; the IF NR switched on mid-run
(the second front end from a fresh state, its own DC blocker included)
with ``set_afnr logmmse`` on the USB radio from then on; and the real-time guard shedding the IF NR.
Each radio's audio and the baseband agree to >= 80 dB in every block,
every state leaf (the radios', the AF NRs', both front ends') to >= 80
dB with integer and bool leaves equal, and the status after every block
is equal.  (OM-LSA is held to the JAX package in
tests/test_torch_noise.py on broadband input: on the USB radio's
band-limited audio its carried gain ``G_prev`` in the stopband bins,
about 53 dB under the passband, is a gain of last-bit differences and
agrees to only 57 dB, while its audio agrees to >= 80 dB.)"""

import json
import os

import numpy as np
import pytest
import torch

import jax
from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision

from torch_parity import (NOISE_BLOCKS, NOISE_RADIOS,
                          SERVED_BLOCKS as BLOCKS,
                          SERVED_RADIOS as RADIOS,
                          SERVED_SWITCH_BEFORE as SWITCH_BEFORE,
                          assert_close, assert_nr_state,
                          assert_spectra_close, assert_state_close,
                          noise_capture, noise_config, port_f32_handoff,
                          run_noise, run_served, served_capture,
                          served_config, snr_db)  # noqa: F401

MIN_DB = 80.0


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("served")
    cap = str(tmp / "baseband_100000000Hz_10-00-00_01-01-2024.wav")
    served_capture(cap)
    runs = {}
    prev = (jax_precision.get_handoff_name(),
            port_precision.get_handoff_name())
    jax_precision.set_handoff_dtype("float32")
    port_precision.set_handoff_dtype("float32")
    try:
        for side in ("jax", "port", "jax_jit"):
            root = str(tmp / side)
            os.makedirs(root)
            with open(os.path.join(root, "config.json"), "w") as f:
                json.dump(served_config(cap), f)
            if side == "port":
                runs[side] = run_served(SDRApp(root, run_pump=False,
                                               device="cpu"), root, True)
                continue
            if side == "jax_jit":
                runs[side] = run_served(JaxApp(root, run_pump=False), root,
                                        False)
                continue
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax, "jit", lambda f, *a, **k: f)
                runs[side] = run_served(JaxApp(root, run_pump=False), root,
                                        False)
    finally:
        jax_precision.set_handoff_dtype(prev[0])
        port_precision.set_handoff_dtype(prev[1])
    return runs


@pytest.mark.parametrize("radio", RADIOS)
def test_audio_matches_jax(served, radio):
    for b in range(BLOCKS):
        j = served["jax"]["audio"][b][radio]
        p = served["port"]["audio"][b][radio]
        assert p.shape == j.shape and p.dtype == np.float32, (b, p.shape)
        if radio == "Q":              # squelched: exact zeros in both
            assert not j.any() and not p.any(), b
        else:
            assert np.mean(j ** 2) > 1e-4, (b, np.mean(j ** 2))
            assert snr_db(j, p) >= MIN_DB, (b, snr_db(j, p))


def test_spectra_and_waterfall_match_jax(served):
    for b in range(BLOCKS):
        jl, pl = served["jax"]["lines"][b], served["port"]["lines"][b]
        assert len(jl) == len(pl) >= 1
        assert_spectra_close(jl, pl)
        assert_spectra_close(served["jax"]["last"][b],
                             served["port"]["last"][b])


def test_vfo_snr_matches_jax(served):
    for b in range(BLOCKS):
        for n in RADIOS:
            j, p = served["jax"]["snr"][b][n], served["port"]["snr"][b][n]
            assert abs(j - p) <= 0.01, (b, n, j, p)
    # on the station and the carrier (NFM, before the switch to USB,
    # whose 2.8 kHz side bands lie inside the carrier's deviation), off
    # the signal
    snr = served["port"]["snr"][SWITCH_BEFORE - 1]
    assert snr["W"] > 15.0 and snr["N"] > 20.0 and snr["Q"] < 20.0, snr


def test_state_matches_jax(served):
    snaps = [("switched", served["jax"]["switched"],
              served["port"]["switched"])]
    snaps += [(b, served["jax"]["state"][b], served["port"]["state"][b])
              for b in range(BLOCKS)]
    for when, j, p in snaps:
        assert set(p["frontend"]) == {"dc"}, when
        assert p["frontend"]["dc"].dtype == torch.complex64
        assert_state_close(j, p, MIN_DB)


def test_status_keys_match_jax(served):
    j, p = served["jax"]["status"], served["port"]["status"]
    assert set(j) == set(p)
    assert p["ready"] and p["mainLoopStarted"] and not p["ifnrEnabled"]


def test_recording_matches_jax(served):
    j, p = served["jax"]["recording"], served["port"]["recording"]
    assert j[:44] == p[:44] and len(j) == len(p) > 44
    a = np.frombuffer(j[44:], "<i2").astype(np.float64)
    b = np.frombuffer(p[44:], "<i2").astype(np.float64)
    assert snr_db(a, b) >= MIN_DB


def test_jitted_jax_app_matches(served):
    """The JAX app as it runs, its steps under ``jax.jit``: the same
    audio bars, and the WFM radio's carried NCO phase within 1e-3 rad of
    the port's modulo 2π (XLA's multiply-add moves it by a rounding)."""
    for b in range(BLOCKS):
        for r in RADIOS:
            j = served["jax_jit"]["audio"][b][r]
            p = served["port"]["audio"][b][r]
            assert p.shape == j.shape, (b, r)
            if r == "Q":
                assert not j.any() and not p.any(), b
            else:
                assert snr_db(j, p) >= MIN_DB, (b, r, snr_db(j, p))
        jp = float(np.asarray(served["jax_jit"]["state"][b]["W"]["vfo"]["xl"]))
        pp = float(served["port"]["state"][b]["W"]["vfo"]["xl"])
        d = (jp - pp + np.pi) % (2 * np.pi) - np.pi
        assert abs(d) <= 1e-3, (b, jp, pp)


NOISE_SCRIPTS = ("config", "midrun", "shed")
PRIMED_AT = 4           # 5 blocks of 12 000 samples hold 12 frames of 4 800


@pytest.fixture(scope="module")
def noise(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("noise")
    cap = str(tmp / "baseband_7100000Hz_10-00-00_01-01-2024.wav")
    noise_capture(cap)
    runs = {}
    for script in NOISE_SCRIPTS:
        for side in ("jax", "port"):
            root = str(tmp / f"{script}_{side}")
            os.makedirs(root)
            with open(os.path.join(root, "config.json"), "w") as f:
                json.dump(noise_config(cap, ifnr=script != "midrun"), f)
            if side == "port":
                runs[script, side] = run_noise(
                    SDRApp(root, run_pump=False, device="cpu"), script, True)
                continue
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax, "jit", lambda f, *a, **k: f)
                runs[script, side] = run_noise(
                    JaxApp(root, run_pump=False), script, False)
    return runs


# The IF NR's first block: its first frame (2·len1 = 4 800 baseband
# samples, 960 audio samples) is exact zeros, then the windowed onset of
# the NR output from zero.  As the radios' filters empty, the NFM radio's
# IF falls to the scale of a rounding (|IF| down to 0 and 1e-19 against
# 1.04 in steady state, IF samples 372-620 of the "shed" session), where
# the discriminator's angle of subnormal products, and the sign of their
# flushed zero, differ between the two packages' radios by whole radians
# (12.2 dB over audio samples 480-600, 111 dB from 960 on).  The
# baseband's own last-bit differences are not the cause: the port's radio
# fed the JAX baseband from the port's carried state agrees with the
# port's audio to >= 107 dB there.  So those 960 samples are held to
# MIN_DB against that run (the baseband is held to the JAX package's
# above, the carried state below), the rest of the block against the
# JAX audio.
ONSET_AUDIO = 960


def nfm_on_jax_baseband(p, j, b) -> np.ndarray:
    """The port's NFM radio on the JAX app's baseband of block ``b``, from
    the port's state after block ``b - 1``."""
    radio, params = p["radio"]["N"]
    state = convert.state_from_jax(p["state"][b - 1]["N"], device="cpu")
    y, _ = radio.apply(params, state, torch.from_numpy(j["bb"][b].copy()))
    return y.numpy()


@pytest.mark.parametrize("script", NOISE_SCRIPTS)
def test_noise_audio_and_baseband_match_jax(noise, script):
    j, p = noise[script, "jax"], noise[script, "port"]
    first_nr = p["primed"].index(True)
    for b in range(NOISE_BLOCKS):
        assert_close(j["bb"][b], p["bb"][b], f"baseband {b}")
        for r in NOISE_RADIOS:
            ja, pa = j["audio"][b][r], p["audio"][b][r]
            assert pa.shape == ja.shape and pa.dtype == np.float32, (b, r)
            if not ja.size:
                continue
            assert np.mean(ja ** 2) > 1e-6, (b, r)
            if r == "N" and b == first_nr:
                ref = nfm_on_jax_baseband(p, j, b)
                assert_close(ref[..., :ONSET_AUDIO], pa[..., :ONSET_AUDIO],
                             f"block {b} radio N onset")
                ja, pa = ja[..., ONSET_AUDIO:], pa[..., ONSET_AUDIO:]
            assert_close(ja, pa, f"block {b} radio {r}")


@pytest.mark.parametrize("script", NOISE_SCRIPTS)
def test_noise_state_and_status_match_jax(noise, script):
    j, p = noise[script, "jax"], noise[script, "port"]
    for b in range(NOISE_BLOCKS):
        assert set(j["state"][b]) == set(p["state"][b]), b
        assert_nr_state(j["state"][b], p["state"][b])
        assert j["status"][b] == p["status"][b], b
    assert j["primed"] == p["primed"] and j["afnr"] == p["afnr"]


def test_noise_sessions(noise):
    """What each script shows, on the port's run: the IF NR primed on its
    fifth block and running to the end; the AF NR output empty until it
    is primed, then one block's audio; switched on mid-run, the second
    front end appears with the priming and from a fresh DC blocker; the
    guard sheds the IF NR on its second slow block, with the reason."""
    cfg = noise["config", "port"]
    assert cfg["primed"] == [b >= PRIMED_AT for b in range(NOISE_BLOCKS)]
    assert all(st["ifnrEnabled"] for st in cfg["status"])
    assert cfg["afnr"] == {"U": {"afnr": "logmmse"}, "N": {"afnr": "off"}}
    u = [a["U"].shape[-1] for a in cfg["audio"]]
    assert u[:PRIMED_AT] == [0] * PRIMED_AT and min(u[PRIMED_AT + 1:]) > 0
    assert "nb" in cfg["state"][0]["N"] and "fmif" in cfg["state"][0]["N"]
    mid = noise["midrun", "port"]
    assert mid["primed"] == [b >= 2 + PRIMED_AT for b in range(NOISE_BLOCKS)]
    first = mid["state"][2 + PRIMED_AT]
    assert "fstate_nr" not in mid["state"][1 + PRIMED_AT]
    assert not np.array_equal(first["fstate_nr"]["dc"], first["fstate"]["dc"])
    shed = noise["shed", "port"]
    on = [st["ifnrEnabled"] for st in shed["status"]]
    assert on == [b <= PRIMED_AT for b in range(NOISE_BLOCKS)]
    assert shed["status"][-1]["ifnrStopReason"] == \
        "Slow processing. Reduce sample rate."

