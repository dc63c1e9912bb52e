"""Radio — the demodulation pipeline (counterpart of
sdrplusplusbrown_tpu/models/radio.py; reference
decoder_modules/radio/src/radio_module.h: VFO → IF chain → demodulator →
AF chain).

Three entry points:

  * ``apply`` — one radio's step, as the app runs it for every enabled
    radio (its ``RadioModuleInstance``): the baseband → RxVFO (translate,
    resample, bandwidth FIR) → IF chain (noise blanker, squelch, FM IF
    filter) → demod (WFM, NFM, AM, USB, LSB, DSB, CW, RAW or a plugin's)
    → AF resampler → de-emphasis, batched over the leading axes of the
    params and state (``()`` for one radio, ``(C,)`` for C radios of one
    mode).  Every FIR, decimator and polyphase stage runs kernel K8, the
    WFM pilot band-pass kernel K9, a batched WFM stereo section kernel
    K10, every AGC kernel K12 and the scan PLL kernel K13;
  * ``apply_shared`` — C VFOs of one mode on one shared wideband, the
    mix-down folded into the first decimator (``SharedRxVFOBank``: K1, or
    K11 then K8 where K1 cannot take the chain).  Broadcast FM
    (``DEMOD_WFM``: stereo, the normalize pilot, no RDS, the de-emphasis
    folded into the audio polyphase) then runs the WFM demod kernel K2
    and the audio polyphase K3, with the wideband spectrum from K4
    alongside; NFM (with or without the squelch) the demod + audio
    kernel K7 on the raw IF buffer (K1's float32 IF when squelched);
    AM, SSB and CW the complex float32 IF through their demods (K8, K12)
    and the AF resampler (K8);
  * ``apply_channelized`` — the wide bank of one mode through the PFB
    K5 and the post-channelizer K6: the NFM scanner (optionally
    squelched) then the demod+audio kernel K7; AM, SSB, DSB and CW their
    demods (K12, K8) and the AF resampler (K8).

A Radio runs on its ``device`` (CUDA unless the caller asks for the
CPU): its params and state are created there and only the wideband input
is moved to it.  Without a CUDA device a default Radio raises at first
use.  Every option of the JAX Radio is taken: the IF chain (the noise
blanker ``nb_enabled``, the squelch, the FM IF filter ``fmif_enabled``,
in that order), the RAW demod, plugin demods registered with
``register_demod_provider`` (``list_demods``), de-emphasis on any demod
(folded into WFM's audio polyphase where it can be, else the standalone
``Deemphasis`` after the AF resampler), WFM's ``stereo``, ``pll_mode``
("scan": the PLL on kernel K13) and ``rds`` (the demod and ``apply``,
``apply_shared`` return ((audio, rds 5 kS/s complex), state); the
app's ``RDSDemod``, models/rds.py, takes it on).  The routes are the
JAX package's: with the blanker or the FM IF filter on, or WFM with the
squelch, ``apply_shared`` leaves its fused routes for the bank's complex
IF through ``_post_vfo``; WFM with RDS, the scan PLL or mono takes the
per-stage route after the discriminator (ops/wfm.py).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..runtime.block import Block, entry_device, lcm_fraction, to_device
from ..ops.demod import AMDemod, CWDemod, FMDemod, SSBDemod, Squelch
from ..ops.fmif import FMIF
from ..ops.recurrence import Deemphasis, NoiseBlanker
from ..ops.resampler import RationalResampler, fold_output_fir
from ..ops.wfm import BroadcastFM
from .rx_vfo import ChannelizedRxVFOBank, RxVFO, SharedRxVFOBank

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

#: Plugin-provided demodulators (the reference's
#: RadioModuleInterface::demodulatorProviders, radio_module_interface.h:
#: 19-60): name → factory(bandwidth, audio_sr) returning a dict with the
#: demod ``block``, its ``if_rate`` and optionally ``stereo`` and
#: ``bandwidth``.
DEMOD_PROVIDERS: dict = {}


def register_demod_provider(name: str, factory):
    DEMOD_PROVIDERS[name.upper()] = factory


def list_demods():
    """Built-in names + plugin-provided names, built-ins in enum order."""
    return list(DEMOD_NAMES) + sorted(DEMOD_PROVIDERS)


class _RawDemod(Block):
    """RAW mode: complex IQ re-interpreted as L = I, R = Q stereo."""

    def apply(self, params, state, x):
        return torch.stack([x.real, x.imag], dim=-2).float(), state


def make_demod(demod_id: int, bandwidth: float, audio_sr: float = 48_000.0,
               stereo: bool = True, rds: bool = False,
               pll_mode: str = "normalize", cw_tone: float = 800.0):
    """(demod block, IF rate, stereo) of ``demod_id`` (the JAX package's
    ``make_demod``)."""
    if_rate = DEMOD_IF_RATES[demod_id][0]
    if demod_id == DEMOD_NFM:
        return FMDemod(if_rate, bandwidth, low_pass=True), if_rate, False
    if demod_id == DEMOD_WFM:
        return BroadcastFM(bandwidth / 2.0, if_rate, stereo=stereo,
                           low_pass=True, rds_out=rds, pll_mode=pll_mode,
                           audio_rate=audio_sr), if_rate, True
    if demod_id == DEMOD_AM:
        return AMDemod(if_rate, bandwidth), if_rate, False
    if demod_id in (DEMOD_USB, DEMOD_LSB, DEMOD_DSB):
        mode = {DEMOD_USB: SSBDemod.USB, DEMOD_LSB: SSBDemod.LSB,
                DEMOD_DSB: SSBDemod.DSB}[demod_id]
        return SSBDemod(mode, bandwidth, if_rate), if_rate, False
    if demod_id == DEMOD_CW:
        return CWDemod(cw_tone, if_rate), if_rate, False
    if demod_id == DEMOD_RAW:
        return _RawDemod(), audio_sr, True
    raise ValueError(f"unknown demod id {demod_id}")


class Radio(Block):
    """Per-VFO demodulation pipeline: RxVFO → IF chain → demod → AF."""

    def __init__(self, in_samplerate: float, demod_id,
                 bandwidth: Optional[float] = None,
                 audio_samplerate: float = 48_000.0,
                 offset_hz: float = 0.0,
                 stereo: bool = True, rds: bool = False,
                 deemphasis: Optional[str] = None,
                 nb_enabled: bool = False, squelch_enabled: bool = False,
                 squelch_level: float = -100.0, fmif_enabled: bool = False,
                 pll_mode: str = "normalize", device="cuda"):
        self.device = torch.device(device)
        self.in_samplerate = float(in_samplerate)
        self.audio_samplerate = float(audio_samplerate)
        provider = None
        if isinstance(demod_id, str):
            name = demod_id.upper()
            if name in DEMOD_IDS:
                demod_id = DEMOD_IDS[name]
            elif name in DEMOD_PROVIDERS:
                provider = DEMOD_PROVIDERS[name]
            else:
                raise ValueError(f"unknown demodulator '{demod_id}'")
        if provider is None:
            self.demod_id = demod_id
            self.demod_name = DEMOD_NAMES[demod_id]
            if bandwidth is None:
                bandwidth = DEMOD_IF_RATES[demod_id][1]
            self.bandwidth = float(bandwidth)
            self.demod, self.if_rate, self.demod_stereo = make_demod(
                demod_id, self.bandwidth, audio_samplerate, stereo, rds,
                pll_mode)
        else:
            # plugin-provided demodulator (radio_module_interface.h:19-60)
            spec = provider(bandwidth, audio_samplerate)
            self.demod_id, self.demod_name = None, name
            self.demod = spec["block"]
            self.if_rate = float(spec["if_rate"])
            self.demod_stereo = bool(spec.get("stereo", False))
            self.bandwidth = float(spec.get("bandwidth")
                                   or bandwidth or self.if_rate)
            demod_id = DEMOD_NFM        # the de-emphasis default
        # IF chain (reference radio_module.h:92-98: NB rate 500/24000,
        # level 10; FMIF 32 bins)
        self.nb = NoiseBlanker(500.0 / 24000.0, 10.0)
        self.squelch = Squelch(squelch_level)
        self.fmif = FMIF(32)
        self.nb_enabled = bool(nb_enabled)
        self.squelch_enabled = squelch_enabled
        self.fmif_enabled = bool(fmif_enabled)
        self.vfo = RxVFO(in_samplerate, self.if_rate, self.bandwidth,
                         offset_hz)
        # AF chain (reference radio_module.h:100-107): the demod may emit
        # audio below the IF rate (WFM's decimated MPX, ops/wfm.py)
        af_in_rate = float(getattr(self.demod, "out_samplerate",
                                   self.if_rate))
        self.af_resamp = None
        if af_in_rate != self.audio_samplerate:
            self.af_resamp = RationalResampler(af_in_rate,
                                               self.audio_samplerate)
        if deemphasis is None:
            deemphasis = "50us" if demod_id == DEMOD_WFM else "none"
        self.deemp_tau = DEEMP_TAUS[deemphasis]
        self.deemp = (Deemphasis(self.deemp_tau, self.audio_samplerate)
                      if self.deemp_tau else None)
        # fold the de-emphasis into the demod's audio polyphase where it
        # has one (WFM): its input history is then the whole state of the
        # cascade; elsewhere the standalone block follows the resampler
        if (self.deemp is not None and self.deemp.fir_k
                and getattr(self.demod, "audio_poly", None) is not None):
            self.demod.audio_poly = fold_output_fir(
                self.demod.audio_poly, self.deemp.impulse())
            self.deemp = None
        need = Fraction(self.vfo.in_multiple)
        r = self.vfo.ratio
        if self.demod.in_multiple > 1:
            need = lcm_fraction(need, Fraction(self.demod.in_multiple) / r)
        r = r * self.demod.ratio
        if self.af_resamp is not None:
            need = lcm_fraction(need,
                                Fraction(self.af_resamp.in_multiple) / r)
            r = r * self.af_resamp.ratio
        self.in_multiple = int(lcm_fraction(need, Fraction(1)))
        self.ratio = r
        self._vfo_shared = self._vfo_channelized = self._fm_pipe = None

    def _dev(self) -> torch.device:
        return entry_device(self.device)

    def _input(self, x):
        """The wideband block as float32 (xr, xi) planes on the device
        (one copy when it comes from the host), its length checked."""
        xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
        if xr.shape[-1] % self.in_multiple:
            raise ValueError(
                f"Radio[{self.demod_name}]: block length {xr.shape[-1]} "
                f"must be a multiple of in_multiple={self.in_multiple}")
        dev = self._dev()
        return (xr.to(dev, torch.float32).contiguous(),
                xi.to(dev, torch.float32).contiguous())

    def _squelch_params(self, level):
        if not self.squelch_enabled:
            return {}
        lvl = self.squelch.default_level if level is None else level
        return {"squelch": {"level": torch.tensor(
            float(lvl), dtype=torch.float32, device=self._dev())}}

    def init_state(self, batch_shape=()):
        st = {"vfo": self.vfo.init_state(batch_shape),
              "demod": self.demod.init_state(batch_shape)}
        if self.nb_enabled:
            st["nb"] = self.nb.init_state(batch_shape)
        if self.fmif_enabled:
            st["fmif"] = self.fmif.init_state(batch_shape)
        af_shape = batch_shape + (2,) if self.demod_stereo else batch_shape
        if self.af_resamp is not None:
            st["af_resamp"] = self.af_resamp.init_state(af_shape,
                                                        torch.float32)
        if self.deemp is not None:
            st["deemp"] = self.deemp.init_state(af_shape)
        return to_device(st, self._dev())

    def init_params(self):
        return self.make_params(self.vfo.offset_hz)

    def make_params(self, offset_hz, squelch_level=None):
        """Runtime params of the per-VFO chain (offset and squelch)."""
        p = {"vfo": to_device(self.vfo.make_params(offset_hz), self._dev())}
        p.update(self._squelch_params(squelch_level))
        return p

    # ---- one radio's step (K8, K9, K10) ----------------------------------
    def apply(self, params, state, x):
        """x: the complex baseband, [T] (shared by every radio of the
        batch) or [..., T], on any device (it is moved to the Radio's) →
        (audio [..., 2, m_aud] float32, new_state), or ((audio, rds),
        new_state) for WFM with ``rds``.  The reference's per-VFO chain
        (radio_module.h:92-107): RxVFO, the IF chain, the demodulator,
        the AF chain; a mono demod's audio comes out twice, as L and R."""
        if x.shape[-1] % self.in_multiple:
            raise ValueError(
                f"Radio[{self.demod_name}]: block length {x.shape[-1]} "
                f"must be a multiple of in_multiple={self.in_multiple}")
        x = x.to(self._dev(), torch.complex64)
        st = dict(state)
        y, st["vfo"] = self.vfo.apply(params["vfo"], state["vfo"], x)
        return self._post_vfo(params, state, st, y)

    def _post_vfo(self, params, state, st, y, mono_out: bool = False):
        """IF chain (noise blanker → squelch → FM IF filter) → demod → AF
        chain."""
        if self.nb_enabled:
            y, st["nb"] = self.nb.apply(None, state["nb"], y)
        if self.squelch_enabled:
            y, _ = self.squelch.apply(params.get("squelch"), None, y)
        if self.fmif_enabled:
            y, st["fmif"] = self.fmif.apply(None, state["fmif"], y)
        y, st["demod"] = self.demod.apply(None, state["demod"], y)
        return self._post_demod(state, st, y, mono_out)

    def _post_demod(self, state, st, y, mono_out: bool = False):
        """AF chain: the resampler, the standalone de-emphasis, the mono →
        stereo copy; a demod's (audio, rds) pair passes its RDS through."""
        rds = None
        if isinstance(y, tuple):
            y, rds = y
        if self.af_resamp is not None:
            y, st["af_resamp"] = self.af_resamp.apply(None,
                                                      state["af_resamp"], y)
        if self.deemp is not None:
            y, st["deemp"] = self.deemp.apply(None, state["deemp"], y)
        if not (self.demod_stereo or mono_out):
            y = torch.stack([y, y], dim=-2)
        if rds is not None:
            return (y, rds), st
        return y, st

    # ---- shared wideband, broadcast FM (K1 → K2 → K3, K4) ---------------
    def _build_vfo_shared(self) -> SharedRxVFOBank:
        if self._vfo_shared is None:
            self._vfo_shared = SharedRxVFOBank(
                self.vfo.in_samplerate, self.vfo.out_samplerate,
                self.vfo.bandwidth, device=self.device)
        return self._vfo_shared

    def make_params_shared(self, offsets_hz, squelch_level=None):
        """Runtime params for apply_shared: per-channel offsets (Hz) →
        host-float64-derived float32 NCO params on the device, and the
        squelch level.  Retuning is a new params dict; nothing is
        rebuilt."""
        vs = self._build_vfo_shared()
        p = {"vfo": vs.make_params(np.asarray(offsets_hz, np.float64))}
        p.update(self._squelch_params(squelch_level))
        return p

    def init_state_shared(self, C: int):
        st = self.init_state((C,))
        st["vfo"] = self._build_vfo_shared().init_state(C)
        return st

    def apply_shared(self, params, state, x, spectrum=None,
                     mono_out: bool = False):
        """x: [T] SHARED wideband, (xr, xi) float32 planes or complex64,
        on any device (it is moved to the Radio's) → (audio [C, 2, m_aud]
        float32, new_state), or ((audio, spectra [n_frames, fft_size]),
        new_state) with a ``spectrum`` SpectrumPath; with ``rds`` the
        audio is the pair (audio, rds [C, m_rds] complex64).
        ``mono_out`` gives a mono demod's audio once, [C, m_aud]; WFM
        audio stays [C, 2, m_aud].  With the noise blanker or the FM IF
        filter on, or WFM with the squelch, the demod takes the bank's
        complex IF through ``_post_vfo`` (the JAX package's non-fused
        route)."""
        fused = not (self.nb_enabled or self.fmif_enabled)
        xr, xi = self._input(x)
        st = dict(state)
        vs = self._build_vfo_shared()
        if fused and self.demod_id == DEMOD_WFM and not self.squelch_enabled:
            # the IF planes into the demod (K2 + K3, or the per-stage route
            # after the discriminator for RDS, the scan PLL or mono)
            if_planes, st["vfo"] = vs.apply(params["vfo"], state["vfo"],
                                            (xr, xi))
            y, st["demod"] = self.demod.apply_planes(
                None, state["demod"], if_planes)
            audio, st = self._post_demod(state, st, y, mono_out)
        elif fused and self.demod_id == DEMOD_NFM and self.deemp is None:
            # the IF buffer straight into K7 (the JAX package's
            # radio.py:397-422), the squelch as K7's per-channel gate.
            # Squelched, the JAX route takes the float32 IF through
            # Squelch and FMDemod (radio.py:252-265 there), so the gate
            # and K7 read K1's float32 IF, not its handoff-dtype buffer,
            # and K7 keeps float32 taps and tails
            sq = self.squelch_enabled
            buf, st["vfo"] = vs.apply(params["vfo"], state["vfo"], (xr, xi),
                                      float32=sq)
            C, m_if = buf.shape[0] // 2, buf.shape[1]
            gate = None
            if self.squelch_enabled:
                iq = buf.float()
                gate = Squelch.gate(torch.hypot(iq[:C], iq[C:]).sum(-1),
                                    m_if, params.get("squelch", {}).get(
                                        "level", self.squelch.default_level))
            audio, st["demod"], st["af_resamp"] = self.fm_audio_pipe().apply(
                gate, state["demod"], state["af_resamp"], buf, m_if,
                dtype=torch.float32 if sq else None)
            if not mono_out:
                audio = torch.stack([audio, audio], dim=-2)
        else:
            y, st["vfo"] = vs.apply(params["vfo"], state["vfo"], (xr, xi),
                                    raw=False)
            audio, st = self._post_vfo(params, state, st, y, mono_out)
        if spectrum is None:
            return audio, st
        spectra, _ = spectrum.apply(None, None, (xr, xi))
        return (audio, spectra), st

    # ---- shared wideband, wide bank of one mode (K5 → K6 → demod) --------
    def can_channelize(self) -> bool:
        """True when the PFB front end can serve this demod: the in/IF
        rate ratio is an even integer and the bandwidth leaves transition
        room (ChannelizedRxVFOBank)."""
        r = self.in_samplerate / self.if_rate
        return (abs(r - round(r)) < 1e-9 and int(round(r)) % 2 == 0
                and self.bandwidth < self.if_rate)

    def _build_vfo_channelized(self) -> ChannelizedRxVFOBank:
        if self._vfo_channelized is None:
            self._vfo_channelized = ChannelizedRxVFOBank(
                self.vfo.in_samplerate, self.vfo.out_samplerate,
                self.vfo.bandwidth, device=self.device)
        return self._vfo_channelized

    def make_params_channelized(self, offsets_hz, squelch_level=None):
        """Runtime params for apply_channelized: per-channel offsets (Hz)
        and the squelch level (dB), on the device."""
        vb = self._build_vfo_channelized()
        p = {"vfo": vb.make_params(np.asarray(offsets_hz, np.float64))}
        p.update(self._squelch_params(squelch_level))
        return p

    def init_state_channelized(self, C: int):
        st = self.init_state((C,))
        st["vfo"] = self._build_vfo_channelized().init_state(C)
        return st

    def fm_audio_pipe(self):
        """The K7 configuration (built once)."""
        if self._fm_pipe is None:
            from ..ops.demod_kernel import FMAudioPipeline
            self._fm_pipe = FMAudioPipeline(self.demod, self.af_resamp)
        return self._fm_pipe

    def _channelized_gate(self, params, sq_sums, m_if: int):
        """The squelch's per-channel gate [C] from K6's Σ|IF| sums (the
        JAX package's fused route), or None without the squelch."""
        if not self.squelch_enabled:
            return None
        level = params.get("squelch", {}).get("level",
                                              self.squelch.default_level)
        return Squelch.gate(sq_sums, m_if, level)

    def apply_channelized(self, params, state, x, mono_out: bool = False,
                          raw_audio: bool = False):
        """x: [T] SHARED wideband, (xr, xi) float32 planes or complex64,
        on any device → (audio, new_state) for C channels of this demod:
        audio [C, 2, m_aud] float32 (the mono audio twice), [C, m_aud]
        with ``mono_out``, or for NFM with ``raw_audio`` the untrimmed
        (audio [C, n_aud] in the handoff dtype, m_aud).  The squelch gates
        a channel whose block mean |IF| is below the level (reference
        squelch.h:55-69): its IF, and so its audio input, is zero.  NFM
        takes the IF buffer into K7; every other demod that
        ``can_channelize`` (AM, SSB, DSB, CW, a plugin's) its complex IF,
        gated by K6's sums, through the demod (K12, K8) and the AF
        resampler (K8), as the JAX package's fused route does.  With the
        noise blanker, the FM IF filter or an NFM de-emphasis on, the
        complex IF goes through ``_post_vfo`` (the JAX package's non-fused
        route; no ``raw_audio``).  A demod that cannot channelize (WFM,
        RAW) raises the bank's ValueError."""
        xr, xi = self._input(x)
        vb = self._build_vfo_channelized()
        st = dict(state)
        nfm = self.demod_id == DEMOD_NFM
        if raw_audio and not nfm:
            raise NotImplementedError(f"raw_audio from {self.demod_name}")
        if self.nb_enabled or self.fmif_enabled or (nfm and self.deemp
                                                    is not None):
            if raw_audio:
                raise NotImplementedError("raw_audio with the noise "
                                          "blanker, the FM IF filter or "
                                          "a de-emphasis")
            y, _, st["vfo"] = vb.apply(params["vfo"], state["vfo"],
                                       (xr, xi))
            return self._post_vfo(params, state, st, y, mono_out)
        if not nfm:
            y, sq_sums, st["vfo"] = vb.apply(params["vfo"], state["vfo"],
                                             (xr, xi))
            gate = self._channelized_gate(params, sq_sums, y.shape[-1])
            if gate is not None:
                y = y * gate[:, None]
            y, st["demod"] = self.demod.apply(None, state["demod"], y)
            return self._post_demod(state, st, y, mono_out)
        (buf, m_if), sq_sums, st["vfo"] = vb.apply(
            params["vfo"], state["vfo"], (xr, xi), raw=True)
        gate = self._channelized_gate(params, sq_sums, m_if)
        audio, st["demod"], st["af_resamp"] = self.fm_audio_pipe().apply(
            gate, state["demod"], state["af_resamp"], buf, m_if,
            raw_audio=raw_audio)
        if raw_audio or mono_out:
            return audio, st
        return torch.stack([audio, audio], dim=-2), st
