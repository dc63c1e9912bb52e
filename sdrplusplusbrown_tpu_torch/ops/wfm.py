"""WFM broadcast stereo demodulator with 19 kHz pilot recovery and the
RDS tap (counterpart of sdrplusplusbrown_tpu/ops/wfm.py; reference
demod/broadcast_fm.h:35-215).

    quadrature FM → MPX halfbands ┬ L+R delay ─────────────────────┐
                                  ├ pilot BPF → PLL or p/|p| → ×vco² ┴ L/R
                                  └ xlate −57 kHz → resample → 5 kHz RDS
    → audio: one polyphase straight to an integer audio rate >= 38 kHz
      (15 kHz low-pass merged, the radio's 50 µs de-emphasis folded in),
      else the 15 kHz low-pass FIR at the MPX rate (the Radio's own AF
      resampler takes it on), or nothing (``low_pass=False``)

Every form of the JAX block: ``stereo`` or mono (L = R = the MPX),
``pll_mode`` "normalize" (p/|p| of the band-passed pilot, delayed one
sample) or "scan" (the PLL, kernel K13 on the card, its VCO delayed one
sample as well: the JAX package's scan route leaves it a sample early,
which costs its stereo separation, see ``_stereo_section``), ``rds_out``
(the protected MPX band widens from 53.5 to 59.5 kHz, and the block returns
((audio, rds), state) with the 5 kS/s complex RDS baseband),
``low_pass``.  ``apply_planes`` (the shared-VFO bank's IF planes) runs
kernel K2 (demod) then K3 (audio polyphase) for the stereo, normalize,
no-RDS form with the merged polyphase; every other form takes the
per-stage route after the discriminator, as the JAX package's
(ops/wfm.py:172,272 there).  ``apply`` (one radio's complex IF) runs the
per-stage chain: the discriminator, the MPX halfbands (K8), the RDS tap
(K8), the stereo section (K10 for a 2-D MPX on the card in the stereo
normalize form; else the pilot band-pass on K9, the PLL on K13 or p/|p|,
and elementwise stages) and the audio polyphase or FIR (K8).  The
design-time taps and the state layout are the JAX package's.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd

import numpy as np
import torch

from ..runtime.block import Block
from . import taps as taps_mod
from .fir import FIR, RealFIR
from .demod import Quadrature, xlator_params
from .pll import PLL, pilot_normalize
from .delay import Delay
from .resampler import (PolyphaseResampler, RationalResampler,
                        design_halfband_stage)
from .xlator import FrequencyXlator


class BroadcastFM(Block):
    #: apply_planes takes the raw [2C, W] front-end handoff
    accepts_raw_planes = True

    def __init__(self, deviation: float, samplerate: float,
                 stereo: bool = True, low_pass: bool = True,
                 rds_out: bool = False, pll_mode: str = "normalize",
                 mpx_decim: int = 4, audio_rate: float | None = None):
        if pll_mode not in ("normalize", "scan"):
            raise ValueError(f"pll_mode {pll_mode!r}")
        self.samplerate = float(samplerate)
        self.stereo = stereo
        self.low_pass = low_pass
        self.rds_out = rds_out
        self.pll_mode = pll_mode
        self.quad = Quadrature(deviation, samplerate)

        # protected MPX band: RDS top 57k+2.4k, else L−R top 38k+15k
        protect = 59500.0 if rds_out else 53500.0
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
        self.pilot_lag = Delay(1)   # normalize-mode stand-in for PLL lag
        # the 15 kHz low-pass is also the anti-alias of any audio rate >=
        # 38 kHz: with an integer audio rate it merges with the AF
        # resampler into one polyphase straight to the audio rate
        self.audio_fir = None
        self.audio_poly = None
        self.in_multiple = self.mpx_decim
        if (audio_rate and low_pass and audio_rate != fsm
                and audio_rate >= 2.0 * 19000.0
                and float(audio_rate).is_integer() and fsm.is_integer()):
            ai, fi = int(audio_rate), int(fsm)
            g = gcd(ai, fi)
            interp, decim = ai // g, fi // g
            proto = taps_mod.low_pass(15000.0, 4000.0, fsm * interp) * interp
            self.audio_poly = PolyphaseResampler(interp, decim, proto)
            self.in_multiple = self.mpx_decim * decim
            self.out_samplerate = float(audio_rate)
            self.ratio = Fraction(1, self.mpx_decim) * Fraction(interp, decim)
        else:
            if low_pass:
                self.audio_taps = taps_mod.low_pass(15000.0, 4000.0, fsm)
                self.audio_fir = RealFIR(self.audio_taps)  # stacked L/R
            self.out_samplerate = fsm
            self.ratio = Fraction(1, self.mpx_decim)
        if rds_out:
            self.rds_xlator = FrequencyXlator(-57000.0, fsm)
            self.rds_resamp = RationalResampler(fsm, 5000.0)
            self.in_multiple = int(np.lcm(
                self.in_multiple,
                self.mpx_decim * self.rds_resamp.in_multiple))
        self.out_channels = 2
        self._pipes = None

    def init_state(self, batch_shape=()):
        f32, c64 = torch.float32, torch.complex64
        st = {
            "quad": self.quad.init_state(batch_shape),
            "mpx_decim": [s.init_state(batch_shape, f32)
                          for s in self.mpx_stages],
            "pilot_fir": self.pilot_fir.init_state(batch_shape),
            "pll": self.pll.init_state(batch_shape),
            "pilot_lag": self.pilot_lag.init_state(batch_shape, c64),
            "lpr_delay": self.lpr_delay.init_state(batch_shape, f32),
            "lmr_delay": self.lmr_delay.init_state(batch_shape, c64),
        }
        if self.stereo and self.pll_mode == "normalize":
            # last K MPX samples: the pilot FIR span, its lag and the
            # delay (the fused kernels' history)
            st["mpx_hist"] = torch.zeros(
                batch_shape + (len(self.pilot_taps),), dtype=f32)
        if self.audio_fir is not None:
            st["audio_fir"] = self.audio_fir.init_state(batch_shape + (2,))
        if self.audio_poly is not None:
            st["audio_rs"] = self.audio_poly.init_state((2,) + batch_shape,
                                                        f32)
        if self.rds_out:
            st["rds_xl"] = self.rds_xlator.init_state(batch_shape)
            st["rds_rs"] = self.rds_resamp.init_state(batch_shape)
        return st

    def fused(self) -> bool:
        """True for the form K2 and K3 take whole: stereo, the normalize
        pilot, no RDS, the merged audio polyphase."""
        return (self.stereo and self.pll_mode == "normalize"
                and not self.rds_out and self.audio_poly is not None
                and bool(self.mpx_stages))

    def pipes(self):
        """(K2 pipeline, K3 pipeline), built once — after Radio has folded
        the de-emphasis into ``audio_poly``; K10 uses the first alone."""
        if self._pipes is None:
            from .wfm_kernel import WFMDemodPipeline, MPXAudioPoly
            self._pipes = (WFMDemodPipeline(self),
                           MPXAudioPoly(self.audio_poly)
                           if self.audio_poly is not None else None)
        return self._pipes

    def apply_planes(self, params, state, planes):
        """planes: IF [2C, m_if] (re rows, im rows) or an (xr, xi) pair of
        [C, m_if] → (audio [C, 2, m_aud] float32, new_state), or ((audio,
        rds [C, m_rds] complex64), new_state) with ``rds_out``."""
        if isinstance(planes, tuple):
            planes = torch.cat(planes, dim=0)
        m_if = planes.shape[-1]
        if not self.fused():
            C = planes.shape[0] // 2
            st = dict(state)
            mpx, st["quad"] = self.quad.apply_planes(
                state["quad"], planes[:C].float(), planes[C:].float())
            return self._after_quad(params, state, st, mpx)
        demod, audio = self.pipes()
        lr, st = demod.apply(state, planes, m_if)
        y, st["audio_rs"] = audio.apply(state["audio_rs"], lr, lr.shape[1])
        return y, st

    def apply(self, params, state, x):
        """x: complex IF [..., m_if] → (audio [..., 2, m_aud] float32,
        new_state), or ((audio, rds [..., m_rds] complex64), new_state)
        with ``rds_out``."""
        st = dict(state)
        mpx, st["quad"] = self.quad.apply(None, state["quad"], x)
        return self._after_quad(params, state, st, mpx)

    def _after_quad(self, params, state, st, mpx):
        mpx_states = []
        for stage, sst in zip(self.mpx_stages, state["mpx_decim"]):
            mpx, nst = stage.apply(None, sst, mpx)
            mpx_states.append(nst)
        st["mpx_decim"] = mpx_states
        rds = None
        if self.rds_out:
            rds_bb, st["rds_xl"] = self.rds_xlator.apply(
                xlator_params(self, mpx.device, "rds_xlator"),
                state["rds_xl"], mpx.to(torch.complex64))
            rds, st["rds_rs"] = self.rds_resamp.apply(None, state["rds_rs"],
                                                      rds_bb)
        if self.stereo:
            lr2 = self._stereo_section(state, st, mpx)
        else:
            lr2 = torch.stack([mpx, mpx], dim=0)
        lr = self._audio_out(state, st, lr2)
        if self.rds_out:
            return (lr, rds), st
        return lr, st

    def _stereo_section(self, state, st, mpx):
        """MPX [..., T] → (L, R) planes [2, ..., T] at the MPX rate.

        In the normalize form a 2-D MPX on the card runs kernel K10
        (ops/wfm_kernel.py), as the TPU runs its fused stereo kernel: only
        ``mpx_hist`` advances there, and ``pilot_fir``, ``pll``,
        ``pilot_lag`` and the delays pass through untouched (switching
        routes mid-stream costs a one-block seam, as in the JAX package,
        ops/wfm.py:178-181).  Elsewhere (one radio's 1-D MPX, the scan
        PLL, or any CPU tensor, as the JAX package's CPU route) the
        per-stage section updates every key."""
        K = len(self.pilot_taps)
        normalize = self.pll_mode == "normalize"
        if normalize:
            hist = torch.cat([state["mpx_hist"], mpx], dim=-1)[..., -K:]
        if normalize and mpx.is_cuda and mpx.dim() == 2:
            from .wfm_kernel import wfm_stereo
            lr2 = wfm_stereo(self.pipes()[0], mpx.contiguous(),
                             state["mpx_hist"].contiguous())
            st["mpx_hist"] = hist
            return lr2
        mpx_c = mpx.to(torch.complex64)
        pilot, st["pilot_fir"] = self.pilot_fir.apply(
            None, state["pilot_fir"], mpx_c)
        if normalize:
            vco = pilot_normalize(pilot)
            vco, st["pilot_lag"] = self.pilot_lag.apply(
                None, state["pilot_lag"], vco)
        else:
            # the PLL's VCO is the pilot's phase with no lag once locked
            # (its error ∠in − phase goes to zero), and the L−R path is
            # delayed one MPX sample more than the pilot FIR's group
            # delay: the VCO is lagged one sample, as the normalize route
            # lags p/|p|.  The JAX package's scan route does not lag it
            # (ops/wfm.py:186 there): at the 125 kHz MPX rate the sample
            # is 0.955 rad of the pilot, 1.91 rad of the 38 kHz carrier,
            # and its stereo separation is −6 dB (R louder than L).  This
            # lag is the routes' one difference (ROADMAP queue 3; pinned
            # by tests/test_torch_radio_forms.py against the JAX route)
            vco, st["pll"] = self.pll.apply(None, state["pll"], pilot)
            vco, st["pilot_lag"] = self.pilot_lag.apply(
                None, state["pilot_lag"], vco)
        vco = vco * complex(np.complex64(self.pilot_phase_corr))
        lpr, st["lpr_delay"] = self.lpr_delay.apply(None, state["lpr_delay"],
                                                    mpx)
        lmr_c, st["lmr_delay"] = self.lmr_delay.apply(
            None, state["lmr_delay"], mpx_c)
        # the conjugate VCO squared downconverts the 38 kHz L−R subcarrier
        vco2 = vco.conj()
        lmr = (lmr_c * vco2 * vco2).real * 2.0
        if normalize:
            st["mpx_hist"] = hist
        return torch.stack([lpr + lmr, lpr - lmr], dim=0)

    def _audio_out(self, state, st, lr2):
        """[2, ..., T] at the MPX rate → audio [..., 2, T'] through the
        (de-emphasis-folded) audio polyphase, or the 15 kHz FIR on the
        stacked L/R, or as it is (``low_pass=False``)."""
        if self.audio_poly is not None:
            lr2, st["audio_rs"] = self.audio_poly.apply(
                None, state["audio_rs"], lr2)
        elif self.audio_fir is not None:
            lr, st["audio_fir"] = self.audio_fir.apply(
                None, state["audio_fir"], torch.movedim(lr2, 0, -2))
            return lr
        return torch.movedim(lr2, 0, -2)
