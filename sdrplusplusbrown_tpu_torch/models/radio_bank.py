"""RadioBank — VFOs of mixed demod modes on one wideband (counterpart of
sdrplusplusbrown_tpu/models/radio_bank.py).

VFOs of one mode form a group, and a group is one batched ``Radio`` that
reads the wideband once: through ``apply_shared`` (the shared front end
K1, or K11 then K8, then the mode's demod) or, for groups of
``CHANNELIZE_MIN_C`` or more whose mode can channelize,
``apply_channelized`` (K5, K6, then K7 for NFM, the demod's K12 and K8
for AM, SSB, DSB and CW).  The
state and params trees are the JAX package's, keyed by demod id, with
shared groups of 1-3 VFOs padded to 4 channels, so ``convert.py``
interchanges them unchanged.  Like every entry point, the bank runs on
its ``device`` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime.block import entry_device
from .radio import DEMOD_AM, DEMOD_NFM, DEMOD_USB, Radio

# the JAX package's crossover from the fused shared front end to the PFB
# channelized path (models/radio_bank.py there)
CHANNELIZE_MIN_C = 16


class VFOSpec:
    def __init__(self, name: str, demod_id: int, offset_hz: float,
                 bandwidth: Optional[float] = None):
        self.name = name
        self.demod_id = demod_id
        self.offset_hz = float(offset_hz)
        self.bandwidth = bandwidth


def multimode8_vfos() -> List[VFOSpec]:
    """The multimode8 configuration's VFOs (the JAX package's
    bench.py:build_multimode8, BASELINE config 2): NFM nfm0..3 at
    −900 kHz + 300 kHz·i, AM am0..1 at 300 kHz + 200 kHz·i, USB usb0..1
    at 800 kHz + 100 kHz·i."""
    return ([VFOSpec(f"nfm{i}", DEMOD_NFM, -900e3 + 300e3 * i)
             for i in range(4)]
            + [VFOSpec(f"am{i}", DEMOD_AM, 300e3 + 200e3 * i)
               for i in range(2)]
            + [VFOSpec(f"usb{i}", DEMOD_USB, 800e3 + 100e3 * i)
               for i in range(2)])


class RadioBank:
    """Group VFO specs by demod mode; one batched Radio per group.

    ``channelize``: "auto" takes the PFB path for groups that
    ``Radio.can_channelize`` and that hold ``CHANNELIZE_MIN_C`` VFOs or
    more, the shared front end otherwise; ``True`` channelizes every
    group and raises ValueError for one that cannot (WFM, RAW)."""

    def __init__(self, in_samplerate: float, vfos: List[VFOSpec],
                 audio_samplerate: float = 48_000.0,
                 channelize: object = "auto", device="cuda",
                 **radio_kwargs):
        self.in_samplerate = float(in_samplerate)
        self.audio_samplerate = float(audio_samplerate)
        self.device = torch.device(device)
        self.groups: Dict[int, List[VFOSpec]] = {}
        for v in vfos:
            self.groups.setdefault(v.demod_id, []).append(v)
        self.radios: Dict[int, Radio] = {}
        self.channelized: Dict[int, bool] = {}
        for demod_id, group in self.groups.items():
            r = Radio(in_samplerate, demod_id, bandwidth=group[0].bandwidth,
                      audio_samplerate=audio_samplerate, device=device,
                      **radio_kwargs)
            self.radios[demod_id] = r
            if channelize == "auto":
                chz = r.can_channelize() and len(group) >= CHANNELIZE_MIN_C
            else:
                chz = bool(channelize)
                if chz and not r.can_channelize():
                    raise ValueError(
                        f"RadioBank: demod {demod_id} cannot channelize "
                        f"(in/IF ratio must be an even integer)")
            self.channelized[demod_id] = chz
        self.in_multiple = math.lcm(
            *[r.in_multiple for r in self.radios.values()]) \
            if self.radios else 1

    def _padded_c(self, d: int) -> int:
        """Shared groups of 1-3 channels pad to 4 (the JAX front-end
        kernel tiles 2C rows in 8-sublane granules); apply() slices the
        outputs back to the real count."""
        C = len(self.groups[d])
        return 4 if (not self.channelized[d] and C < 4) else C

    def init_state(self):
        return {d: (r.init_state_channelized(len(self.groups[d]))
                    if self.channelized[d]
                    else r.init_state_shared(self._padded_c(d)))
                for d, r in self.radios.items()}

    def make_params(self):
        out = {}
        for d, r in self.radios.items():
            offs = np.array([v.offset_hz for v in self.groups[d]])
            if self.channelized[d]:
                out[d] = r.make_params_channelized(offs)
            else:
                cp = self._padded_c(d)
                if cp > len(offs):
                    offs = np.concatenate(
                        [offs, np.repeat(offs[-1:], cp - len(offs))])
                out[d] = r.make_params_shared(offs)
        return out

    def apply(self, params, state, x, mono_out: bool = False):
        """x: [T] wideband, complex64 or (xr, xi) float32 planes, on any
        device → (dict demod_id → audio, new state).  A group's audio is
        [C_d, 2, T_out_d] float32; with ``mono_out`` a mono demod's is
        [C_d, T_out_d] (the sink duplicates it), while a stereo (WFM)
        group's stays [C_d, 2, T_out_d], as in the JAX package: the dict
        may then hold both shapes."""
        xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
        if xr.shape[-1] % self.in_multiple:
            raise ValueError(f"RadioBank: block length {xr.shape[-1]} must "
                             f"be a multiple of in_multiple="
                             f"{self.in_multiple}")
        # one split and copy of the wideband, shared by every group
        dev = entry_device(self.device)
        x = (xr.to(dev, torch.float32).contiguous(),
             xi.to(dev, torch.float32).contiguous())
        outs, new_state = {}, {}
        for d, radio in self.radios.items():
            if self.channelized[d]:
                y, new_state[d] = radio.apply_channelized(
                    params[d], state[d], x, mono_out=mono_out)
            else:
                y, new_state[d] = radio.apply_shared(
                    params[d], state[d], x, mono_out=mono_out)
                y = y[:len(self.groups[d])]
            outs[d] = y
        return outs, new_state

    def vfo_names(self) -> List[Tuple[str, int, int]]:
        """(name, demod_id, index within group)."""
        return [(v.name, d, i) for d, group in self.groups.items()
                for i, v in enumerate(group)]
