"""Radio — the demodulation pipeline (counterpart of
sdrplusplusbrown_tpu/models/radio.py; reference
decoder_modules/radio/src/radio_module.h: VFO → IF chain → demodulator →
AF chain).

The port runs the broadcast-FM receive chain over a SHARED wideband:
``apply_shared`` feeds C VFOs through the front-end kernel K1, the WFM
demod kernel K2 and the audio polyphase K3, with the wideband spectrum
from K4 alongside.  Supported: ``DEMOD_WFM`` with stereo, the normalize
pilot, no RDS, no noise blanker / squelch / FM IF filter, and the
de-emphasis folded into the audio polyphase.  Everything else raises
``NotImplementedError``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np

from ..runtime.block import Block, lcm_fraction
from ..ops.recurrence import Deemphasis
from ..ops.resampler import fold_output_fir
from ..ops.wfm import BroadcastFM
from .rx_vfo import RxVFO, SharedRxVFOBank

# reference: radio_module_interface.h:6-16 (RADIO_IFACE_MODE_* order)
DEMOD_NFM, DEMOD_WFM, DEMOD_AM, DEMOD_DSB = 0, 1, 2, 3
DEMOD_USB, DEMOD_CW, DEMOD_LSB, DEMOD_RAW = 4, 5, 6, 7

DEMOD_NAMES = ["NFM", "WFM", "AM", "DSB", "USB", "CW", "LSB", "RAW"]
DEMOD_IDS = {n: i for i, n in enumerate(DEMOD_NAMES)}

#: (IF samplerate, default bandwidth) per demod id; RAW uses audio SR.
DEMOD_IF_RATES = {
    DEMOD_NFM: (50_000.0, 12_500.0),
    DEMOD_WFM: (500_000.0, 150_000.0),
    DEMOD_AM: (15_000.0, 10_000.0),
    DEMOD_DSB: (24_000.0, 4_600.0),
    DEMOD_USB: (24_000.0, 2_800.0),
    DEMOD_CW: (3_000.0, 200.0),
    DEMOD_LSB: (24_000.0, 2_800.0),
    DEMOD_RAW: (48_000.0, 48_000.0),
}

DEEMP_TAUS = {"none": None, "22us": 22e-6, "50us": 50e-6, "75us": 75e-6}


class Radio(Block):
    """Per-VFO demodulation pipeline: RxVFO → demod → AF chain."""

    def __init__(self, in_samplerate: float, demod_id,
                 bandwidth: Optional[float] = None,
                 audio_samplerate: float = 48_000.0,
                 offset_hz: float = 0.0,
                 stereo: bool = True, rds: bool = False,
                 deemphasis: Optional[str] = None,
                 nb_enabled: bool = False, squelch_enabled: bool = False,
                 fmif_enabled: bool = False, pll_mode: str = "normalize"):
        if isinstance(demod_id, str):
            if demod_id.upper() not in DEMOD_IDS:
                raise ValueError(f"unknown demodulator '{demod_id}'")
            demod_id = DEMOD_IDS[demod_id.upper()]
        if demod_id != DEMOD_WFM:
            raise NotImplementedError(
                f"demod {DEMOD_NAMES[demod_id]} is not ported yet (WFM only)")
        if nb_enabled or squelch_enabled or fmif_enabled:
            raise NotImplementedError("IF chain (NB / squelch / FMIF) is "
                                      "not ported yet")
        self.in_samplerate = float(in_samplerate)
        self.audio_samplerate = float(audio_samplerate)
        self.demod_id = demod_id
        self.demod_name = DEMOD_NAMES[demod_id]
        self.if_rate = DEMOD_IF_RATES[demod_id][0]
        if bandwidth is None:
            bandwidth = DEMOD_IF_RATES[demod_id][1]
        self.bandwidth = float(bandwidth)
        self.demod = BroadcastFM(self.bandwidth / 2.0, self.if_rate,
                                 stereo=stereo, low_pass=True, rds_out=rds,
                                 pll_mode=pll_mode,
                                 audio_rate=audio_samplerate)
        self.vfo = RxVFO(in_samplerate, self.if_rate, self.bandwidth,
                         offset_hz)
        if self.demod.out_samplerate != self.audio_samplerate:
            raise NotImplementedError("separate AF resampler")
        # the de-emphasis (reference radio_module.h:100-107) folds into the
        # demod's audio polyphase: its input history is then the whole
        # state of the cascade (ops/resampler.py:fold_output_fir)
        self.deemp_tau = DEEMP_TAUS["50us" if deemphasis is None
                                    else deemphasis]
        if self.deemp_tau:
            deemp = Deemphasis(self.deemp_tau, self.audio_samplerate)
            if not deemp.fir_k:
                raise NotImplementedError("de-emphasis pole too slow to fold")
            self.demod.audio_poly = fold_output_fir(self.demod.audio_poly,
                                                    deemp.impulse())
        need = Fraction(self.vfo.in_multiple)
        r = self.vfo.ratio
        if self.demod.in_multiple > 1:
            need = lcm_fraction(need, Fraction(self.demod.in_multiple) / r)
        self.in_multiple = int(lcm_fraction(need, Fraction(1)))
        self.ratio = r * self.demod.ratio
        self._vfo_shared = None

    def init_state(self, batch_shape=()):
        return {"vfo": self.vfo.init_state(batch_shape),
                "demod": self.demod.init_state(batch_shape)}

    def _build_vfo_shared(self) -> SharedRxVFOBank:
        if self._vfo_shared is None:
            self._vfo_shared = SharedRxVFOBank(
                self.vfo.in_samplerate, self.vfo.out_samplerate,
                self.vfo.bandwidth)
        return self._vfo_shared

    def make_params_shared(self, offsets_hz):
        """Runtime params for apply_shared: per-channel offsets (Hz) →
        host-float64-derived float32 NCO params.  Retuning is a new params
        dict; nothing is rebuilt."""
        vs = self._build_vfo_shared()
        return {"vfo": vs.make_params(np.asarray(offsets_hz, np.float64))}

    def init_state_shared(self, C: int):
        st = self.init_state((C,))
        st["vfo"] = self._build_vfo_shared().init_state(C)
        return st

    def apply_shared(self, params, state, x, spectrum=None):
        """x: [T] SHARED wideband, (xr, xi) float32 planes or complex64,
        on the device the chain should run on → (audio [C, 2, m_aud]
        float32, new_state), or ((audio, spectra [n_frames, fft_size]),
        new_state) with a ``spectrum`` SpectrumPath.  Params and state may
        sit on any device; they are moved to the input's."""
        xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
        T = xr.shape[-1]
        if T % self.in_multiple:
            raise ValueError(
                f"Radio[{self.demod_name}]: block length {T} must be a "
                f"multiple of in_multiple={self.in_multiple}")
        xr = xr.float().contiguous()
        xi = xi.float().contiguous()
        st = dict(state)
        if_planes, st["vfo"] = self._build_vfo_shared().apply(
            params["vfo"], state["vfo"], (xr, xi))
        audio, st["demod"] = self.demod.apply_planes(None, state["demod"],
                                                     if_planes)
        if spectrum is None:
            return audio, st
        spectra, _ = spectrum.apply(None, None, (xr, xi))
        return (audio, spectra), st
