"""RxVFO — translate → rational resample → bandwidth FIR (counterpart of
sdrplusplusbrown_tpu/models/rx_vfo.py; reference channel/rx_vfo.h:89-121).

``RxVFO`` is the plain per-channel block.  ``SharedRxVFOBank`` serves C
VFOs of one shared wideband, with the mix-down folded into the first
decimating FIR so the wideband is read once for all channels: through the
whole-chain front-end kernel K1 (ops/mono_frontend.py) where the JAX
package's window solver takes the chain, else through K11 and one K8 per
later stage (ops/plane_frontend.py).
``ChannelizedRxVFOBank`` serves wide banks through the 2×-oversampled
PFB (kernel K5, ops/channelizer_kernel.py) and the post-channelizer
(kernel K6, ops/chan_frontend.py).

The banks are entry points: each owns a device (``device=``, CUDA unless
the caller asks for the CPU), creates its params and state there, and
moves only the wideband input to it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.block import Block, entry_device, to_device
from ..ops import taps as taps_mod
from ..ops.fir import FIR
from ..ops.xlator import FrequencyXlator, nco_params
from ..ops.resampler import RationalResampler


class RxVFO(Block):
    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, offset_hz: float = 0.0):
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        self.offset_hz = float(offset_hz)
        self.xlator = FrequencyXlator(-offset_hz, in_samplerate)
        self.resamp = RationalResampler(in_samplerate, out_samplerate)
        self.filter_needed = bandwidth != out_samplerate
        if self.filter_needed:
            fw = bandwidth / 2.0
            self.fir = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate))
        self.ratio = self.resamp.ratio
        self.in_multiple = self.resamp.in_multiple

    def make_params(self, offset_hz):
        """Per-call retune; ``offset_hz`` may be per-channel."""
        return {"xl": nco_params(-np.asarray(offset_hz, np.float64),
                                 self.in_samplerate)}

    def init_params(self):
        return self.make_params(self.offset_hz)

    def init_state(self, batch_shape=()):
        st = {"xl": self.xlator.init_state(batch_shape),
              "rs": self.resamp.init_state(batch_shape)}
        if self.filter_needed:
            st["fir"] = self.fir.init_state(batch_shape)
        return st

    def apply(self, params, state, x):
        if params is None:
            params = self.init_params()
        st = dict(state)
        y, st["xl"] = self.xlator.apply(params["xl"], state["xl"], x)
        y, st["rs"] = self.resamp.apply(None, state["rs"], y)
        if self.filter_needed:
            y, st["fir"] = self.fir.apply(None, state["fir"], y)
        return y, st


class SharedRxVFOBank(Block):
    """RxVFO over a SHARED wideband: per-channel mix-down folded into the
    first predecimation stage (ops/fused_frontend.py), the rest of the
    chain on the decimated planes.  The route is chosen once, here, from
    the chain's geometry: ``route`` is "K1" where ``_solve_geometry``
    solves it, else "K11" (K11 then K8 per stage) — at 2.4 MS/s the NFM,
    AM, SSB and WFM chains take K1 and CW does not; at 10 MS/s none
    does.  A chain without a predecimation stage (NFM at 96 kS/s: the
    polyphase resampler alone) has nothing to fold the mix-down into:
    ``route`` "xlate" broadcasts the wideband to one translator a channel
    and runs the chain's stages on K8, as the JAX package's fallback
    does."""

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, device="cuda"):
        from ..ops.fused_frontend import SharedXlateDecimFIR
        self.device = torch.device(device)
        self.base = RxVFO(in_samplerate, out_samplerate, bandwidth)
        self.in_samplerate = float(in_samplerate)
        blocks = self.base.resamp.chain.named_blocks
        self.has_predec = bool(blocks) and blocks[0][0] == "decim"
        self.fused, self.rest_decim = None, []
        if self.has_predec:
            stage0 = blocks[0][1].stages[0]
            self.fused = SharedXlateDecimFIR(stage0.taps, in_samplerate,
                                             stage0.decim)
            self.rest_decim = blocks[0][1].stages[1:]
        self.rest = [(n, b) for n, b in blocks if n != "decim"]
        self.ratio = self.base.ratio
        self.in_multiple = self.base.in_multiple
        self.filter_needed = self.base.filter_needed
        from ..ops import mono_frontend
        self.route = ("xlate" if not self.has_predec
                      else "K1" if mono_frontend.solves(self) else "K11")
        self._pipe = None

    def make_params(self, offsets_hz):
        from ..ops.fused_frontend import fused_params
        offs = np.asarray(offsets_hz, np.float64)
        if not self.has_predec:
            p = {"xl": self.base.make_params(offs)["xl"]}
        else:
            p = {"fused": fused_params(offs, self.in_samplerate,
                                       self.fused.decim)}
        return to_device(p, entry_device(self.device))

    def init_state(self, C: int):
        if not self.has_predec:
            st = {"xl": self.base.xlator.init_state((C,))}
        else:
            st = {"fused": self.fused.init_state((C,)),
                  "rest_decim": [s.init_state((C,))
                                 for s in self.rest_decim]}
        for n, b in self.rest:
            st[n] = b.init_state((C,))
        if self.filter_needed:
            st["fir"] = self.base.fir.init_state((C,))
        return to_device(st, entry_device(self.device))

    def stage_blocks(self) -> list:
        """The chain's stages after stage 0, in order: the remaining
        decimators, the polyphase resampler, the bandwidth FIR."""
        blocks = list(self.rest_decim) + [b for _, b in self.rest]
        if self.filter_needed:
            blocks.append(self.base.fir)
        return blocks

    def stage_tails(self, state) -> list:
        """Each later stage's carried complex tail, in stage order."""
        tails = list(state.get("rest_decim", []))
        tails += [state[n] for n, _ in self.rest]
        if self.filter_needed:
            tails.append(state["fir"])
        return tails

    def write_tails(self, state, tails) -> None:
        """Store ``tails`` (stage order) in the state layout."""
        n = len(self.rest_decim)
        if self.has_predec:
            state["rest_decim"] = list(tails[:n])
        for i, (name, _) in enumerate(self.rest):
            state[name] = tails[n + i]
        if self.filter_needed:
            state["fir"] = tails[-1]

    def pipe(self):
        """The route's pipeline (built once)."""
        if self._pipe is None:
            if self.route == "K1":
                from ..ops.mono_frontend import MonoVFOPipeline
                self._pipe = MonoVFOPipeline(self)
            else:
                from ..ops.plane_frontend import PlaneVFOPipeline
                self._pipe = PlaneVFOPipeline(self)
        return self._pipe

    def apply(self, params, state, x, raw: bool = True,
              float32: bool = False):
        """x: [T] shared wideband, complex64 or (xr, xi) float32 planes →
        (IF, new state).  With ``raw`` the IF is the buffer [2C, T·ratio]
        (re rows then im rows) that K2 and K7 take: in the handoff dtype
        from K1 (float32 with ``float32``, K1's trimmed IF), float32 from
        K11/K8.  Without, it is the complex64 [C, T·ratio] IF (float32
        from either route)."""
        dev = entry_device(self.device)
        xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
        x = (xr.to(dev, torch.float32), xi.to(dev, torch.float32))
        if not self.has_predec:
            return self._apply_xlate(params, state, x, raw)
        buf, st = self.pipe().apply(params["fused"], state, x,
                                    raw=raw and not float32)
        if raw:
            return buf, st
        C = buf.shape[0] // 2
        return torch.complex(buf[:C], buf[C:]), st

    def _apply_xlate(self, params, state, x, raw: bool):
        """The "xlate" route: the wideband through each channel's
        translator (the JAX package's broadcast), then every stage of the
        chain (K8 on the card); the IF float32, as [2C, m] planes with
        ``raw``."""
        st = dict(state)
        y, st["xl"] = self.base.xlator.apply(params["xl"], state["xl"],
                                             torch.complex(*x))
        tails = []
        for blk, tail in zip(self.stage_blocks(), self.stage_tails(state)):
            y, t = blk.apply(None, tail, y)
            tails.append(t)
        self.write_tails(st, tails)
        if raw:
            return torch.cat([y.real, y.imag]).float().contiguous(), st
        return y, st


class ChannelizedRxVFOBank(Block):
    """RxVFO bank over a shared wideband via the 2×-oversampled PFB: the
    band is split once into M = in/out bins at twice the channel rate,
    then each channel gathers its nearest bin, rotates by the residual
    offset and runs the 2:1 anti-alias and bandwidth FIRs (the designs of
    the JAX package's bank, models/rx_vfo.py there).  Offsets are runtime
    params: a retune is a new params dict."""

    def __init__(self, in_samplerate: float, out_samplerate: float,
                 bandwidth: float, device="cuda"):
        from ..ops.channelizer import OversampledChannelizer
        self.device = torch.device(device)
        self.in_samplerate = float(in_samplerate)
        self.out_samplerate = float(out_samplerate)
        self.bandwidth = float(bandwidth)
        r = in_samplerate / out_samplerate
        M = int(round(r))
        if abs(r - M) > 1e-9 or M % 2:
            raise ValueError(f"ChannelizedRxVFOBank: in/out rate ratio {r} "
                             f"must be an even integer")
        if not bandwidth < out_samplerate:
            raise ValueError(f"ChannelizedRxVFOBank: bandwidth {bandwidth} "
                             f"must be < out rate {out_samplerate}")
        self.M = M
        # prototype: passband to out_sr/2 + bw/2, stopband from
        # 3/2·out_sr − bw/2 (the alias edge at the 2·out_sr bin rate)
        proto = taps_mod.low_pass(out_samplerate, out_samplerate - bandwidth,
                                  in_samplerate)
        self.chz = OversampledChannelizer(in_samplerate, M, proto)
        self.fine = FrequencyXlator(0.0, 2.0 * out_samplerate)
        # 2:1 anti-alias: stopband from out_sr − bw/2
        self.decim2 = FIR(taps_mod.low_pass(out_samplerate / 2.0,
                                            (out_samplerate - bandwidth) / 2.0,
                                            2.0 * out_samplerate), decim=2)
        self.filter_needed = bandwidth != out_samplerate
        if self.filter_needed:
            fw = bandwidth / 2.0
            self.fir = FIR(taps_mod.low_pass(fw, fw * 0.1, out_samplerate))
        from fractions import Fraction
        self.ratio = Fraction(1, M)
        self.in_multiple = M
        self._pfb = self._post = None
        self._rows = None       # (weakref to a bin index, version, rows)
        self._iota = {}

    def make_params(self, offsets_hz):
        """Per-channel offsets (Hz) → nearest bin, the residual NCO and
        its host-float64 spans for the post-channelizer's phase."""
        from ..ops.chan_frontend import BS, SPAN
        from ..ops.xlator import _TWO_PI
        f = np.asarray(offsets_hz, np.float64)
        k = np.round(f / self.out_samplerate)
        delta = f - k * self.out_samplerate
        omega = -delta * (_TWO_PI / (2.0 * self.out_samplerate))
        return to_device(
            {"bin": torch.from_numpy(
                np.mod(k.astype(np.int64), self.M).astype(np.int32)),
             "xl": nco_params(-delta, 2.0 * self.out_samplerate),
             "xl_bs": torch.tensor(np.mod(omega * BS, _TWO_PI),
                                   dtype=torch.float32),
             "xl_sup": torch.tensor(np.mod(omega * SPAN, _TWO_PI),
                                    dtype=torch.float32)},
            entry_device(self.device))

    def init_state(self, C: int):
        st = {"chz": self.chz.init_state(),
              "xl": self.fine.init_state((C,)),
              "d2": self.decim2.init_state((C,))}
        if self.filter_needed:
            st["fir"] = self.fir.init_state((C,))
        return to_device(st, entry_device(self.device))

    def pipes(self):
        """(K5 configuration, K6 configuration), built once."""
        if self._pfb is None:
            from ..ops.chan_frontend import ChanPostPipeline
            self._pfb = self.chz.pfb()
            self._post = ChanPostPipeline(self)
        return self._pfb, self._post

    def gathers(self, C: int) -> bool:
        """Whether K5 computes only the C channels' bins (their rows of
        each plane, [bin | M + bin]) rather than the whole plane: above
        M = 64 (the large-M kernel; the register-resident kernels compute
        every bin anyway) and for fewer channels than bins."""
        from ..ops.channelizer_kernel import PFB_REG_M
        return self.M > PFB_REG_M and C < self.M

    def gather_rows(self, bin_idx: torch.Tensor) -> torch.Tensor:
        """int32 [2C] K5 row list [bin | M + bin] of ``bin_idx``, made on
        its device once for each bin tensor (a retune is a new params
        dict, so a new tensor: its first block makes the list, with no
        host copy; the blocks after reuse it)."""
        import weakref
        hit = self._rows
        if hit is not None and hit[0]() is bin_idx and \
                hit[1] == bin_idx._version:
            return hit[2]
        rows = torch.cat([bin_idx, bin_idx + self.M]).to(torch.int32) \
            .contiguous()
        self._rows = (weakref.ref(bin_idx), bin_idx._version, rows)
        return rows

    def apply(self, params, state, x, raw: bool = False):
        """x: [T] shared wideband, (xr, xi) float32 planes or complex →
        (y, sq_sums [C], state'): y the complex [C, T/M] IF, or with
        ``raw`` (buf [2C, W] in the handoff dtype, m_if); sq_sums = Σ|y|
        per channel over the block (the squelch's block mean × m_if).
        Runs K5 then K6 (their plain versions on the CPU); where
        ``gathers``, K5 computes only the channels' rows and K6 reads
        channel c at rows c and C + c."""
        dev = entry_device(self.device)
        xr, xi = x if isinstance(x, tuple) else (x.real, x.imag)
        xr = xr.to(dev, torch.float32).contiguous()
        xi = xi.to(dev, torch.float32).contiguous()
        T = xr.shape[-1]
        if T % self.M:
            raise ValueError(f"block length {T} not a multiple of M={self.M}")
        pfb, post = self.pipes()
        Tb = 2 * T // self.M
        st = dict(state)
        C = params["bin"].shape[0]
        rows = bin_idx = None
        if self.gathers(C):
            rows = self.gather_rows(params["bin"])
            key = (str(dev), C)
            if key not in self._iota:
                self._iota[key] = torch.arange(C, dtype=torch.int32,
                                               device=dev)
            bin_idx = self._iota[key]
        bins, st["chz"] = pfb.apply(state["chz"], (xr, xi),
                                    post.plan(Tb)["Tb_pad"], rows=rows)
        return post.apply(params, st, bins, Tb, raw=raw, bin_idx=bin_idx)
