"""WFM broadcast stereo demodulator (counterpart of
sdrplusplusbrown_tpu/ops/wfm.py; reference demod/broadcast_fm.h:35-215).

    quadrature FM → MPX halfbands ┬ L+R delay ────────────────┐
                                  └ pilot BPF → p/|p| → ×vco² ┴ L/R
    → audio polyphase straight to the audio rate (15 kHz low-pass
      merged, the radio's 50 µs de-emphasis folded in)

The port supports the configuration the app's radios and the shared-VFO
main path use: stereo, ``pll_mode="normalize"``, no RDS, an integer audio
rate.  ``apply_planes`` (the shared-VFO bank's IF planes) runs kernel K2
(demod) then K3 (audio polyphase).  ``apply`` (one radio's complex IF, the
per-radio step) runs the JAX package's per-stage chain: the
discriminator, the MPX halfbands (K8), the stereo section (K10 for a 2-D
MPX on the card; else the pilot band-pass on K9 and plain elementwise
stages) and the audio polyphase (K8).  The design-time taps and the state
layout are the JAX package's.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd

import numpy as np
import torch

from ..runtime.block import Block
from . import taps as taps_mod
from .fir import FIR, RealFIR
from .demod import Quadrature
from .pll import PLL, pilot_normalize
from .delay import Delay
from .resampler import PolyphaseResampler, design_halfband_stage


class BroadcastFM(Block):
    #: apply_planes takes the raw [2C, W] front-end handoff
    accepts_raw_planes = True

    def __init__(self, deviation: float, samplerate: float,
                 stereo: bool = True, low_pass: bool = True,
                 rds_out: bool = False, pll_mode: str = "normalize",
                 mpx_decim: int = 4, audio_rate: float | None = None):
        if not stereo or rds_out or pll_mode != "normalize" or not low_pass:
            raise NotImplementedError(
                "BroadcastFM port: stereo, normalize pilot, low-pass, no RDS")
        self.samplerate = float(samplerate)
        self.stereo = stereo
        self.low_pass = low_pass
        self.rds_out = rds_out
        self.pll_mode = pll_mode
        self.quad = Quadrature(deviation, samplerate)

        protect = 53500.0          # L−R top 38k+15k (no RDS)
        mpx_decim = int(mpx_decim)
        if mpx_decim < 1 or mpx_decim & (mpx_decim - 1):
            raise ValueError(f"mpx_decim {mpx_decim} not a power of 2")
        while mpx_decim > 1 and samplerate / mpx_decim <= 2.0 * protect * 1.02:
            mpx_decim //= 2
        self.mpx_decim = mpx_decim
        self.mpx_stages = []
        fs = self.samplerate
        d = mpx_decim
        while d > 1:
            self.mpx_stages.append(RealFIR(design_halfband_stage(
                fs, protect).astype(np.float32), decim=2))
            fs /= 2.0
            d //= 2
        fsm = fs

        self.pilot_taps = taps_mod.band_pass_complex(
            18750.0, 19250.0, 3000.0, fsm, odd_tap_count=True)
        self.pilot_fir = FIR(self.pilot_taps)
        w19 = taps_mod.hz_to_rads(19000.0, fsm)
        # the complex band-pass carries a constant phase w0·count/2 that
        # squaring doubles into the 38 kHz carrier: cancel it
        self.pilot_phase_corr = complex(
            np.exp(-1j * w19 * (len(self.pilot_taps) / 2.0)))
        self.pll = PLL(25000.0 / fsm, init_freq=w19,
                       min_freq=taps_mod.hz_to_rads(18750.0, fsm),
                       max_freq=taps_mod.hz_to_rads(19250.0, fsm))
        d = (len(self.pilot_taps) - 1) // 2 + 1
        self.lpr_delay = Delay(d)
        self.lmr_delay = Delay(d)
        self.pilot_lag = Delay(1)
        if not (audio_rate and audio_rate != fsm and audio_rate >= 38000.0
                and float(audio_rate).is_integer() and fsm.is_integer()):
            raise NotImplementedError(
                "BroadcastFM port: audio rate must be an integer >= 38 kHz")
        ai, fi = int(audio_rate), int(fsm)
        g = gcd(ai, fi)
        interp, decim = ai // g, fi // g
        proto = taps_mod.low_pass(15000.0, 4000.0, fsm * interp) * interp
        self.audio_poly = PolyphaseResampler(interp, decim, proto)
        self.in_multiple = self.mpx_decim * decim
        self.out_samplerate = float(audio_rate)
        self.ratio = Fraction(1, self.mpx_decim) * Fraction(interp, decim)
        self.out_channels = 2
        self._pipes = None

    def init_state(self, batch_shape=()):
        f32, c64 = torch.float32, torch.complex64
        return {
            "quad": self.quad.init_state(batch_shape),
            "mpx_decim": [s.init_state(batch_shape, f32)
                          for s in self.mpx_stages],
            "pilot_fir": self.pilot_fir.init_state(batch_shape),
            "pll": self.pll.init_state(batch_shape),
            "pilot_lag": self.pilot_lag.init_state(batch_shape, c64),
            "lpr_delay": self.lpr_delay.init_state(batch_shape, f32),
            "lmr_delay": self.lmr_delay.init_state(batch_shape, c64),
            # last K MPX samples: the pilot FIR span, its lag and the delay
            "mpx_hist": torch.zeros(batch_shape + (len(self.pilot_taps),),
                                    dtype=f32),
            "audio_rs": self.audio_poly.init_state((2,) + batch_shape, f32),
        }

    def pipes(self):
        """(K2 pipeline, K3 pipeline), built once — after Radio has folded
        the de-emphasis into ``audio_poly``."""
        if self._pipes is None:
            from .wfm_kernel import WFMDemodPipeline, MPXAudioPoly
            self._pipes = (WFMDemodPipeline(self),
                           MPXAudioPoly(self.audio_poly))
        return self._pipes

    def apply_planes(self, params, state, planes):
        """planes: IF [2C, m_if] (re rows, im rows) or an (xr, xi) pair of
        [C, m_if] → (audio [C, 2, m_aud] float32, new_state)."""
        if isinstance(planes, tuple):
            planes = torch.cat(planes, dim=0)
        m_if = planes.shape[-1]
        demod, audio = self.pipes()
        lr, st = demod.apply(state, planes, m_if)
        y, st["audio_rs"] = audio.apply(state["audio_rs"], lr, lr.shape[1])
        return y, st

    def apply(self, params, state, x):
        """x: complex IF [..., m_if] → (audio [..., 2, m_aud] float32,
        new_state)."""
        st = dict(state)
        mpx, st["quad"] = self.quad.apply(None, state["quad"], x)
        return self._after_quad(params, state, st, mpx)

    def _after_quad(self, params, state, st, mpx):
        mpx_states = []
        for stage, sst in zip(self.mpx_stages, state["mpx_decim"]):
            mpx, nst = stage.apply(None, sst, mpx)
            mpx_states.append(nst)
        st["mpx_decim"] = mpx_states
        lr2 = self._stereo_section(state, st, mpx)
        return self._audio_out(state, st, lr2), st

    def _stereo_section(self, state, st, mpx):
        """MPX [..., T] → (L, R) planes [2, ..., T] at the MPX rate.

        A 2-D MPX on the card runs kernel K10 (ops/wfm_kernel.py), as the
        TPU runs its fused stereo kernel: only ``mpx_hist`` advances
        there, and ``pilot_fir``, ``pll``, ``pilot_lag`` and the delays
        pass through untouched (switching routes mid-stream costs a
        one-block seam, as in the JAX package, ops/wfm.py:178-181).
        Elsewhere (one radio's 1-D MPX, or any CPU tensor, as the JAX
        package's CPU route) the per-stage section updates every key."""
        K = len(self.pilot_taps)
        hist = torch.cat([state["mpx_hist"], mpx], dim=-1)[..., -K:]
        if mpx.is_cuda and mpx.dim() == 2:
            from .wfm_kernel import wfm_stereo
            lr2 = wfm_stereo(self.pipes()[0], mpx.contiguous(),
                             state["mpx_hist"].contiguous())
            st["mpx_hist"] = hist
            return lr2
        mpx_c = mpx.to(torch.complex64)
        pilot, st["pilot_fir"] = self.pilot_fir.apply(
            None, state["pilot_fir"], mpx_c)
        vco = pilot_normalize(pilot)
        vco, st["pilot_lag"] = self.pilot_lag.apply(None, state["pilot_lag"],
                                                    vco)
        vco = vco * complex(np.complex64(self.pilot_phase_corr))
        lpr, st["lpr_delay"] = self.lpr_delay.apply(None, state["lpr_delay"],
                                                    mpx)
        lmr_c, st["lmr_delay"] = self.lmr_delay.apply(
            None, state["lmr_delay"], mpx_c)
        # the conjugate VCO squared downconverts the 38 kHz L−R subcarrier
        vco2 = vco.conj()
        lmr = (lmr_c * vco2 * vco2).real * 2.0
        st["mpx_hist"] = hist
        return torch.stack([lpr + lmr, lpr - lmr], dim=0)

    def _audio_out(self, state, st, lr2):
        """[2, ..., T] at the MPX rate → audio [..., 2, T'] through the
        (de-emphasis-folded) audio polyphase."""
        lr2, st["audio_rs"] = self.audio_poly.apply(None, state["audio_rs"],
                                                    lr2)
        return torch.movedim(lr2, 0, -2)
