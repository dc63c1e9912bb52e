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
and the NCO phase within 1e-3 rad modulo 2π."""

import json
import os

import numpy as np
import pytest
import torch

import jax
from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
from sdrplusplusbrown_tpu.ops import precision as jax_precision
from sdrplusplusbrown_tpu_torch.app import SDRApp
from sdrplusplusbrown_tpu_torch.ops import precision as port_precision

from torch_parity import (SERVED_BLOCKS as BLOCKS,
                          SERVED_RADIOS as RADIOS,
                          SERVED_SWITCH_BEFORE as SWITCH_BEFORE,
                          assert_spectra_close, assert_state_close,
                          port_f32_handoff, run_served, served_capture,
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
