"""RDS in the port against the JAX package on the CPU (tests/test_rds.py's
oracles), with the same seeded inputs:

  * the group codec and ``RDSDecoder`` (a copy, not an import): check
    words, syndromes, block kinds, encoded groups and the decoder's
    status on the PS and RadioText groups, with a bit error, equal;
  * ``RDSDemod`` (AGC on K12's complex form, Costas, the band-pass,
    Costas, M&M on K13's plain versions) on test_rds_demod_chain's
    biphase signal: hard bits and ``valid`` equal in every block, the
    state >= 80 dB (integer leaves equal; the clock's fractional sample
    position within 1e-5 of a sample, torch_parity.assert_mm_state), the
    decoders' PI and PS equal and right;
  * the whole stack: ``Radio(WFM, rds=True)`` on a synthesised 1 MS/s
    FM capture carrying RDS (torch_parity.rds_fm_iq), through ``apply``
    (four 0.3 s blocks, each package's RDSDemod on its own radio's RDS
    baseband: the hard bits and ``valid`` equal; the loops' state carries
    the baseband's own ~80 dB difference as a phase, ~1e-4 rad, so the
    state is held in the test above, on one input) and ``apply_shared`` (two
    blocks, two VFOs): the audio and the 5 kS/s RDS baseband >= 80 dB
    from JAX's, every state leaf >= 80 dB, and the decoders' PI, PS and
    RT equal JAX's and the station's;
  * ``convert`` on the new state keys, both ways, and a block from the
    converted state;
  * the served app: ``rds: true`` in config.json on one WFM radio and
    ``set_rds 1`` mid-run on another, ``get_rds`` equal to the JAX app's
    after every block, both decoding the station.

The JAX Radio runs its demod under jit (torch_parity.jit_methods) and its
VFO op by op (``apply_shared``: all of it under jit).  The JAX RDSDemod
runs each stage under a jit of its own where its state is compared: under
one jit over the whole demod XLA
fuses the AGC's output into the first Costas loop's input, and the loop
frequencies, which sit near zero on these signals, then agree to ~75 dB,
not 80.  Where only its bits are compared (the stack), it runs under
jit, as tests/test_rds.py runs it."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sdrplusplusbrown_tpu.models import rds as jax_rds
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
from sdrplusplusbrown_tpu_torch.models import rds
from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_WFM, Radio

from torch_parity import (RDS_PI, RDS_PS, RDS_RT, assert_close,
                          assert_mm_state, assert_state_close, jit_methods,
                          leaves, planes, port_f32_handoff, rds_biphase,
                          rds_bits, rds_fm_iq)  # noqa: F401

MIN_DB = 80.0


def test_codec_matches_jax():
    rng = np.random.default_rng(0)
    for d in list(rng.integers(0, 1 << 16, 200)) + [0, 0xFFFF, 0xABCD]:
        d = int(d)
        assert rds.rds_checkword(d) == jax_rds.rds_checkword(d)
        for kind in ("A", "B", "C", "Cp", "D"):
            blk = rds.rds_encode_block(d, kind)
            assert blk == jax_rds.rds_encode_block(d, kind)
            assert rds.identify_block(blk) == kind
            bad = blk ^ (1 << int(rng.integers(0, 26)))
            assert rds.rds_syndrome(bad) == jax_rds.rds_syndrome(bad)
            assert rds.identify_block(bad) == jax_rds.identify_block(bad)
    g = rds.rds_encode_group(RDS_PI, 2, True, 7, 9, 0x1234, 0x5678)
    assert g == jax_rds.rds_encode_group(RDS_PI, 2, True, 7, 9, 0x1234,
                                         0x5678)
    np.testing.assert_array_equal(rds.rds_group_bits(g),
                                  jax_rds.rds_group_bits(g))


def test_decoder_matches_jax():
    """The PS and RadioText groups twice, a bit error in the second copy
    (sync lost and found again), pushed in uneven pieces."""
    bits = rds_bits(2)
    bits[900] ^= 1
    pd, jd = rds.RDSDecoder(), jax_rds.RDSDecoder()
    for a, b in zip([0, 5, 333, 900, 1200], [5, 333, 900, 1200, len(bits)]):
        pd.push_bits(bits[a:b])
        jd.push_bits(bits[a:b])
        assert pd.status() == jd.status()
    st = pd.status()
    assert st["synced"] and st["pi"] == RDS_PI and st["pty"] == 5
    assert st["ps"] == RDS_PS and st["radiotext"] == RDS_RT


def _decoders_equal(pd, jd):
    assert pd.status() == jd.status()
    st = pd.status()
    assert st["synced"] and st["pi"] == RDS_PI and st["ps"] == RDS_PS, st
    return st


def test_rds_demod_matches_jax():
    """test_rds_demod_chain's signal: the biphase at 5 kS/s on a carrier
    phase of 0.7 rad in noise; two 2 500-sample blocks, as that test's."""
    fs, B = 5000.0, 2500
    rng = np.random.default_rng(3)
    t = np.arange(2 * B) / fs
    x = (rds_biphase(t, rds_bits(2)) * np.exp(1j * 0.7)
         + 0.02 * (rng.standard_normal(2 * B)
                   + 1j * rng.standard_normal(2 * B))).astype(np.complex64)
    jb, pb = jax_rds.RDSDemod(), rds.RDSDemod()
    for blk in (jb.agc, jb.costas, jb.fir, jb.costas2, jb.recov):
        jit_methods(blk)
    jstep = functools.partial(jb.apply, None)
    js, ps = jb.init_state(()), pb.init_state(())
    jd, pd = jax_rds.RDSDecoder(), rds.RDSDecoder()
    for b in range(2):
        xb = x[b * B:(b + 1) * B]
        (jh, jv), js = jstep(js, jnp.asarray(xb))
        (ph, pv), ps = pb.apply(None, ps, torch.from_numpy(xb))
        jh, jv = np.asarray(jh), np.asarray(jv)
        assert ph.dtype == torch.uint8 and pv.dtype == torch.bool
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(ph.numpy()[jv], jh[jv])
        assert_mm_state(js, ps)
        jd.push_bits(jh[jv])
        pd.push_bits(ph.numpy()[pv.numpy()])
    assert _decoders_equal(pd, jd)["groups"] >= 8


FS_STACK = 1_000_000.0
STACK_BLOCKS = 4


@pytest.fixture(scope="module")
def station():
    radio = Radio(FS_STACK, DEMOD_WFM, rds=True, device="cpu")
    B = radio.in_multiple * 38                 # 0.304 s
    return B, rds_fm_iq(STACK_BLOCKS * B, FS_STACK, offset=100e3, seed=4)


@pytest.fixture(scope="module")
def jax_radio():
    """The JAX ``Radio(WFM, rds=True)``, its demod under jit (one compile
    for the module's tests; the VFO op by op, as in
    test_torch_radio_forms.py)."""
    jr = JaxRadio(FS_STACK, DEMOD_WFM, rds=True)
    jit_methods(jr.demod)
    return jr


def test_radio_rds_apply_matches_jax(station, jax_radio):
    """``Radio.apply`` with ``rds`` then ``RDSDemod`` a block, batch ()."""
    B, x = station
    jr = jax_radio
    pr = Radio(FS_STACK, DEMOD_WFM, rds=True, device="cpu")
    assert pr.in_multiple == jr.in_multiple
    jp, pp = jr.make_params(100e3), pr.make_params(100e3)
    js, ps = jr.init_state(()), pr.init_state(())
    jb, pb = jax_rds.RDSDemod(), rds.RDSDemod()
    jstep = jax.jit(functools.partial(jb.apply, None))
    jds, pds = jb.init_state(()), pb.init_state(())
    jd, pd = jax_rds.RDSDecoder(), rds.RDSDecoder()
    for b in range(STACK_BLOCKS):
        xb = x[b * B:(b + 1) * B]
        (ja, jbb), js = jr.apply(jp, js, jnp.asarray(xb))
        (pa, pbb), ps = pr.apply(pp, ps, torch.from_numpy(xb))
        assert pbb.dtype == torch.complex64 and pbb.shape == (B // 200,)
        assert_close(ja, pa, f"audio {b}")
        assert_close(jbb, pbb, f"rds {b}")
        assert_state_close(js, ps, MIN_DB)
        (jh, jv), jds = jstep(jds, jbb)
        (ph, pv), pds = pb.apply(None, pds, pbb)
        jh, jv = np.asarray(jh), np.asarray(jv)
        np.testing.assert_array_equal(pv.numpy(), jv)
        np.testing.assert_array_equal(ph.numpy()[jv], jh[jv])
        jd.push_bits(jh[jv])
        pd.push_bits(ph.numpy()[pv.numpy()])
    assert _decoders_equal(pd, jd)["radiotext"] == RDS_RT


def test_radio_rds_apply_shared_matches_jax(station):
    """``apply_shared`` with ``rds``: two VFOs on the station (one 2 kHz
    off its centre; a VFO on noise alone turns rounding into audio), the
    per-stage route after the discriminator; two blocks.  The cold-start
    block is compared after its first 20 ms: the IF rises there out of
    the front end's filter transient, where the discriminator takes
    angles of an IF at rounding scale, and the port's shared front end
    (K1's plain version) and the JAX package's CPU plane route round it
    differently (the RDS tap, 20 dB under the MPX, to ~70 dB there); as
    the bank tests do."""
    B, x = station
    offs = [100e3, 102e3]
    jr = jit_methods(JaxRadio(FS_STACK, DEMOD_WFM, rds=True), "apply_shared")
    pr = Radio(FS_STACK, DEMOD_WFM, rds=True, device="cpu")
    jp, pp = jr.make_params_shared(offs), pr.make_params_shared(offs)
    js, ps = jr.init_state_shared(2), pr.init_state_shared(2)
    for b in range(2):
        xb = x[b * B:(b + 1) * B]
        (ja, jbb), js = jr.apply_shared(jp, js, jnp.asarray(xb))
        (pa, pbb), ps = pr.apply_shared(pp, ps, planes(xb))
        assert pa.shape == (2, 2, B * 48 // 1000) and pbb.shape == (2,
                                                                   B // 200)
        skip = 960 if b == 0 else 0, 100 if b == 0 else 0
        assert_close(np.asarray(ja)[..., skip[0]:], pa[..., skip[0]:],
                     f"audio {b}")
        assert_close(np.asarray(jbb)[..., skip[1]:], pbb[..., skip[1]:],
                     f"rds {b}")
        assert_state_close(js, ps, MIN_DB)


APP_BLOCKS = 9          # of 200 000 samples at 1 MS/s: 1.8 s of signal


def test_app_rds_matches_jax(tmp_path):
    """The served app with two WFM radios on the station: W with ``rds:
    true`` in config.json, V switched on by ``set_rds 1`` after the first
    block.  Each block, both packages' ``get_rds`` on both radios are
    equal; by the end both decoders hold the station's PI, PS and RT.
    The JAX app runs as it serves, its steps under jit (the decoded
    groups are the comparison, not the audio)."""
    from sdrplusplusbrown_tpu.app import SDRApp as JaxApp
    from sdrplusplusbrown_tpu_torch.app import SDRApp
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    cap = str(tmp_path / "baseband_100000000Hz_10-00-00_01-01-2024.wav")
    write_wav(cap, rds_fm_iq(int(2.0 * FS_STACK), FS_STACK, offset=-200e3,
                             seed=6), FS_STACK, bits=32)
    got = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        os.makedirs(root)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump({"source": {"type": "file", "path": cap, "loop": True},
                       "fftSize": 4096, "fftRate": 20, "pump": "manual",
                       "modules": {
                           "W": {"type": "radio", "demod": "WFM",
                                 "offset": -200e3, "rds": True},
                           "V": {"type": "radio", "demod": "WFM",
                                 "offset": -200e3}}}, f)
        app = (JaxApp(root, run_pump=False) if side == "jax"
               else SDRApp(root, run_pump=False, device="cpu"))
        app.start()
        seen = []
        for b in range(APP_BLOCKS):
            if b == 1:
                r = app.modules["V"].handle_debug_command("set_rds", "1")
                assert r == {"status": "ok", "rds": True}
            assert app.pump_step(1) == 1
            seen.append({n: app.modules[n].handle_debug_command("get_rds", "")
                         for n in ("W", "V")})
        # lcm(the spectrum's 50 000-sample interval, the radios' 8 000)
        assert app.pump_block_len == 200_000
        app.shutdown()
        got[side] = seen
    assert got["port"][0]["V"] == {"error": "rds not enabled"}
    for b, (j, p) in enumerate(zip(got["jax"], got["port"])):
        assert p == j, (b, j, p)
    for n in ("W", "V"):
        st = got["port"][-1][n]
        assert st["synced"] and st["pi"] == RDS_PI, st
        assert st["ps"] == RDS_PS and st["radiotext"] == RDS_RT, st


def test_state_converts_both_ways(station, jax_radio):
    """``convert`` on the new state keys: a JAX ``Radio(rds=True)`` state
    and a JAX ``RDSDemod`` state after one block into the port
    (``state_from_jax``) and back (``state_to_jax``) unchanged, and the
    port's next block from the converted state agrees with the JAX
    package's from its own (audio, RDS tap, hard bits, valid)."""
    from sdrplusplusbrown_tpu_torch import convert
    B, x = station
    jr = jax_radio
    pr = Radio(FS_STACK, DEMOD_WFM, rds=True, device="cpu")
    jb, pb = jax_rds.RDSDemod(), rds.RDSDemod()
    jp, pp = jr.make_params(100e3), pr.make_params(100e3)
    (_, jbb), js = jr.apply(jp, jr.init_state(()), jnp.asarray(x[:B]))
    _, jds = jb.apply(None, jb.init_state(()), jbb)
    for tree in (js, jds):
        back = convert.state_to_jax(convert.state_from_jax(tree,
                                                           device="cpu"))
        for (path, a), (_, b) in zip(leaves(tree), leaves(back)):
            a = np.asarray(a)
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)
    ps = convert.state_from_jax(js, device="cpu")
    pds = convert.state_from_jax(jds, device="cpu")
    assert set(ps["demod"]) >= {"rds_xl", "rds_rs", "pll", "pilot_lag"}
    xb = x[B:2 * B]
    (ja, jbb), _ = jr.apply(jp, js, jnp.asarray(xb))
    (pa, pbb), _ = pr.apply(pp, ps, torch.from_numpy(xb))
    assert_close(ja, pa, "audio")
    assert_close(jbb, pbb, "rds")
    (jh, jv), _ = jb.apply(None, jds, jbb)
    (ph, pv), _ = pb.apply(None, pds, torch.from_numpy(np.array(jbb)))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ph.numpy()[pv.numpy()],
                                  np.asarray(jh)[np.asarray(jv)])
