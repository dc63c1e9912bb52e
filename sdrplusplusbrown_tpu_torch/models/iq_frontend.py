"""IQFrontEnd — the signal-path head (counterpart of
sdrplusplusbrown_tpu/models/iq_frontend.py; reference
core/src/signal_path/iq_frontend.{h,cpp}): power-of-two decimation, the
DC blocker, IQ inversion and the spectrum branch.  The splitter fan-out
to the radios is free: the baseband it returns is what every
``Radio.apply`` takes.

The decimator's FIR stages run kernel K8 and the spectrum kernel K4f.
The DC blocker is the JAX package's XLA ``linear_recurrence``, which has
no Pallas body: here ``ops/recurrence.py:linear_recurrence``, kernel K15
on the card (one launch a block) and on the host the torch doubling scan
that pairs as the JAX package's does.  An entry
point: it runs on ``device`` (CUDA unless the caller asks for the CPU),
keeps its state there and moves only the input to it.  The pluggable
baseband preprocessors (``preprocessors``: (name, block) pairs, such as
the IF noise reduction ``ops/logmmse.py:IFNRLogMMSE``) run in order after
the DC blocker and the conjugate, before the spectrum, each with its
state under ``pre_<name>``.
"""

from __future__ import annotations

import math
from fractions import Fraction

import torch

from ..ops.recurrence import DCBlocker
from ..ops.resampler import PowerDecimator
from ..ops.spectrum import SpectrumPath
from ..runtime.block import Block, entry_device, to_device


class Conjugate(Block):
    """IQ inversion (reference math/conjugate.h, iq_frontend.cpp:42)."""

    def apply(self, params, state, x):
        return x.conj().resolve_conj(), state


class IQFrontEnd(Block):
    """Wideband block → ((baseband, dB spectra frames), state).

    Defaults mirror the reference's MainWindow::init wiring: decimation 1,
    DC blocker rate 50/SR when enabled, FFT 65 536 bins at 20 fps,
    Nuttall window (gui/main_window.cpp:104, core.cpp:559-561)."""

    def __init__(self, samplerate: float, decim_ratio: int = 1,
                 dc_blocking: bool = False, invert_iq: bool = False,
                 fft_size: int = 65536, fft_rate: float = 20.0,
                 fft_window: str = "nuttall", preprocessors=(),
                 device="cuda"):
        self.device = torch.device(device)
        self.samplerate = float(samplerate)
        self.decim_ratio = int(decim_ratio)
        self.effective_sr = self.samplerate / self.decim_ratio
        self.decim = (PowerDecimator(self.samplerate, self.decim_ratio)
                      if self.decim_ratio > 1 else None)
        # reference: genDCBlockRate = 50/SR (iq_frontend.h:84-86), on the
        # complex baseband after the decimator
        self.dc = DCBlocker(50.0 / self.effective_sr) if dc_blocking else None
        self.conj = Conjugate() if invert_iq else None
        self.preprocessors = list(preprocessors)
        self.spectrum = SpectrumPath(self.effective_sr, fft_size, fft_rate,
                                     fft_window, device=device)
        need = self.spectrum.in_multiple * self.decim_ratio
        for _, p in self.preprocessors:
            need = math.lcm(need, p.in_multiple * self.decim_ratio)
        self.in_multiple = need
        self.ratio = Fraction(1, self.decim_ratio)

    def init_state(self, batch_shape=()):
        st = {}
        if self.decim is not None:
            st["decim"] = self.decim.init_state(batch_shape)
        if self.dc is not None:
            st["dc"] = self.dc.init_state(batch_shape)
        for name, p in self.preprocessors:
            st[f"pre_{name}"] = p.init_state(batch_shape)
        return to_device(st, entry_device(self.device))

    def apply(self, params, state, x):
        """x: complex wideband [T] on any device (moved to the front
        end's) → ((baseband [T / decim_ratio] complex64, spectra
        [n_frames, fft_size]), new_state)."""
        if x.shape[-1] % self.in_multiple:
            raise ValueError(f"IQFrontEnd: block length {x.shape[-1]} must "
                             f"be a multiple of {self.in_multiple}")
        x = x.to(entry_device(self.device), torch.complex64)
        st = dict(state)
        if self.decim is not None:
            x, st["decim"] = self.decim.apply(None, state["decim"], x)
        if self.dc is not None:
            x, st["dc"] = self.dc.apply(None, state["dc"], x)
        if self.conj is not None:
            x, _ = self.conj.apply(None, None, x)
        for name, p in self.preprocessors:
            x, st[f"pre_{name}"] = p.apply(None, state[f"pre_{name}"], x)
        spectra, _ = self.spectrum.apply(None, None, x)
        return (x, spectra), st
