"""The app's per-radio step: the port's ``Radio.apply`` (the plain versions
of K8, K9 and the per-stage stereo section) against the JAX package's
``Radio.apply`` on the CPU, WFM and NFM with the squelch on (as the app
builds every radio), at batch () and (8,), over three blocks with a retune
before the third.  Audio and every state leaf agree to >= 80 dB in every
block, the cold-start block included (float32 on both sides).  The JAX
side runs op by op: under ``jax.jit`` XLA fuses the NCO's phase advance
into a multiply-add, which moves the carried phase by one float32 rounding
of omega·n (~1e-4 rad at these block lengths, ~85 dB of the IF).

The retune keeps each radio on a carrier: on noise alone the
discriminator's angle is ill-conditioned wherever the IF passes near zero
and the two packages' last-bit differences show there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.radio import (Radio, DEMOD_NFM,
                                                     DEMOD_WFM)

from torch_parity import (FS, assert_state_close, nfm_iq, port_f32_handoff,
                          snr_db, tone_oracles, wfm_iq)  # noqa: F401

T = 24_000
MIN_DB = 80.0
WFM_OFFS = np.linspace(-0.9e6, 0.9e6, 8)
NFM_OFFS = np.linspace(-0.9e6, 0.7e6, 8) + 917.0
NFM_HOP = 40e3           # the retune: each NFM radio to the next carrier


def _signal(demod, batch):
    if demod == DEMOD_WFM:
        offs = WFM_OFFS if batch else WFM_OFFS[5:6]
        return wfm_iq(3 * T, offs, seed=2), offs, offs + 20e3
    offs = NFM_OFFS if batch else NFM_OFFS[2:3]
    carriers = np.concatenate([offs, offs + NFM_HOP])
    x = nfm_iq(3 * T, carriers, range(len(carriers)), seed=3)
    return x, offs, offs + NFM_HOP


@pytest.mark.parametrize("batch", [(), (8,)])
@pytest.mark.parametrize("demod", [DEMOD_WFM, DEMOD_NFM])
def test_apply_matches_jax(demod, batch):
    jr = JaxRadio(FS, demod, squelch_enabled=True)
    pr = Radio(FS, demod, squelch_enabled=True, device="cpu")
    assert pr.in_multiple == jr.in_multiple and T % pr.in_multiple == 0
    x, offs, retuned = _signal(demod, batch)
    if not batch:
        offs, retuned = float(offs[0]), float(retuned[0])
    js = jr.init_state(batch)
    ps = pr.init_state(batch)
    for b in range(3):
        o = offs if b < 2 else retuned
        xb = x[b * T:(b + 1) * T]
        ja, js = jr.apply(jr.make_params(o), js, jnp.asarray(xb))
        pa, ps = pr.apply(pr.make_params(o), ps, torch.from_numpy(xb))
        ja = np.asarray(ja)
        assert pa.shape == ja.shape == batch + (2, T // 50)
        s = snr_db(ja, pa.numpy())
        assert s >= MIN_DB, (b, s)
        assert_state_close(js, ps, MIN_DB)
        if b == 1 and demod == DEMOD_WFM:    # on its carrier, settled
            tone_snr, sep = tone_oracles(pa.numpy().reshape(-1, 2, T // 50),
                                         [0])
            assert tone_snr > 30.0 and sep > 20.0, (tone_snr, sep)
    if demod == DEMOD_NFM:
        np.testing.assert_array_equal(pa[..., 0, :], pa[..., 1, :])


def test_squelch_gives_exact_silence_and_streams():
    """An NFM radio tuned off the signal, squelch at −30 dB: exact zeros
    from the first block on; and two half blocks give the one-block
    audio."""
    pr = Radio(FS, DEMOD_NFM, squelch_enabled=True, device="cpu")
    x = torch.from_numpy(nfm_iq(2 * T, [3e5], [0], seed=4))
    quiet = pr.make_params(-5e5, squelch_level=-30.0)
    st = pr.init_state(())
    for b in range(2):
        a, st = pr.apply(quiet, st, x[b * T:(b + 1) * T])
        assert not a.any()
    loud = pr.make_params(3e5)
    one, _ = pr.apply(loud, pr.init_state(()), x)
    st = pr.init_state(())
    a1, st = pr.apply(loud, st, x[:T])
    a2, st = pr.apply(loud, st, x[T:])
    assert snr_db(one.numpy(), torch.cat([a1, a2], -1).numpy()) > 100.0
    with pytest.raises(ValueError):
        pr.apply(loud, st, x[:T + 1])


@pytest.mark.parametrize("demod", [DEMOD_WFM, DEMOD_NFM])
def test_params_and_state_round_trip(demod):
    """JAX tree → port → JAX keeps every key, shape, dtype and value (the
    lists rs.decim and mpx_decim, the pll dict, audio_rs [2, ..., hist]),
    and a port step on converted JAX trees equals the JAX step."""
    jr = JaxRadio(FS, demod, squelch_enabled=True)
    pr = Radio(FS, demod, squelch_enabled=True, device="cpu")
    x, offs, _ = _signal(demod, (8,))
    jp = jr.make_params(offs)
    js = jr.init_state((8,))
    _, js = jr.apply(jp, js, jnp.asarray(x[:T]))
    ps = convert.state_from_jax(js, device="cpu")
    pp = convert.params_from_jax(jp, device="cpu")
    assert_state_close(js, ps, 300.0)
    back = convert.state_to_jax(ps)
    assert_state_close(back, ps, 300.0)
    assert_state_close(jp, pp, 300.0)
    native = pr.make_params(offs)
    assert_state_close(convert.state_to_jax(native), pp, 300.0)
    if demod == DEMOD_WFM:
        assert ps["demod"]["audio_rs"].shape[:2] == (2, 8)
        assert set(ps["demod"]["pll"]) == {"phase", "freq"}
        assert len(ps["demod"]["mpx_decim"]) == 2
    ja, js2 = jr.apply(jp, js, jnp.asarray(x[T:2 * T]))
    pa, ps2 = pr.apply(pp, ps, torch.from_numpy(x[T:2 * T]))
    assert snr_db(np.asarray(ja), pa.numpy()) >= MIN_DB
    assert_state_close(js2, ps2, MIN_DB)


def test_apply_device_rule():
    """A default Radio runs on the card: without one it raises at first
    use, RDS and the scan PLL among its options; on the CPU they build,
    and WFM with the squelch runs through apply_shared (the complex IF
    through _post_vfo, as the JAX package's route)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        Radio(FS, DEMOD_NFM, squelch_enabled=True).init_state(())
    with pytest.raises(RuntimeError):
        Radio(FS, DEMOD_WFM, rds=True).init_state(())
    rds = Radio(FS, DEMOD_WFM, rds=True, device="cpu")
    assert rds.demod.rds_out and set(rds.init_state(())["demod"]) >= {
        "rds_xl", "rds_rs"}
    scan = Radio(FS, DEMOD_WFM, pll_mode="scan", device="cpu")
    assert scan.demod.pll_mode == "scan"
    assert "mpx_hist" not in scan.init_state(())["demod"]
    wfm = Radio(FS, DEMOD_WFM, squelch_enabled=True, device="cpu")
    audio, st = wfm.apply_shared(
        wfm.make_params_shared([0.0], squelch_level=0.0),
        wfm.init_state_shared(1),
        torch.zeros(wfm.in_multiple, dtype=torch.complex64))
    m = wfm.in_multiple * 48_000 // int(FS)
    assert audio.shape == (1, 2, m) and not audio.any()
    assert set(st) == {"vfo", "demod"}
