"""LogMMSE noise reduction (counterpart of
sdrplusplusbrown_tpu/ops/logmmse.py; reference
misc_modules/noise_reduction_logmmse/src/logmmse.h): Ephraim-Malah
log-MMSE with the decision-directed a-priori SNR over a 50 %-overlap STFT
(Slen = ⌊0.02·SR⌋ even, nFFT = 2·Slen, Hann window scaled by len2/Σwin),
the noise PSD tracked from a sliding history of H frames: the mean of the
last 12 frames on the audio branch, per-bin deviation thresholding
against a histogram-mode background estimate on the wideband branch.

All frames of a block go through one batched FFT; the per-frame
bookkeeping (the history ring and the ξ recursion) is kernel K14
(``logmmse_frames``, csrc/logmmse.cu) on the card, one launch a block,
and on the host its plain version, a Python loop of torch ops over the
block's few frames.  Nothing in ``apply`` reads a value back to the host:
the frame counters are 0-d tensors, the ring slot is read and written by
a tensor index, and the ``hold`` param selects with ``torch.where``.  On
the card K14 writes a block's F slots into the rings in place and hands
them over to the state it returns (``hand_over``, the counterpart of a
donated buffer in JAX): the state it was given loses its rings, and a
second use of it raises (``check_rings``).  On the host the plain
version copies the rings once per ``apply``, and the caller's state
stays as it was.

``AFNRLogMMSE``'s 5-sample moving average is kernel K8 (``fir_rows``),
as the JAX package's runs its real-tap Pallas FIR; the rest is torch ops
(``torch.fft``, reductions, ``scatter_add_``) where the JAX package has
XLA code.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..kernels import _build
from ..runtime.block import Block, device_const
from .fir import device_taps
from .fir_kernel import fir_rows

ERASED_SAMPLE = 1e9  # bgnoise.h:19
NBUCKETS = 1000      # bgnoise.h:11
SKIP_FRAMES = 10     # bgnoise.h:12

# Abramowitz & Stegun 5.1.53 (x ≤ 1) and 5.1.56 (x > 1), float32
_E1_A = np.array([-0.57721566, 0.99999193, -0.24991055, 0.05519968,
                  -0.00976004, 0.00107857], np.float32)
_E1_P = np.array([8.5733287401, 18.0590169730, 8.6347608925,
                  0.2677737343], np.float32)
_E1_Q = np.array([9.5733223454, 25.6329561486, 21.0996530827,
                  3.9584969228], np.float32)


def expn_e1(x: torch.Tensor) -> torch.Tensor:
    """Exponential integral E1(x), x > 0, float32 (|ε| < 2e-7)."""
    a, p, q = ([float(v) for v in c] for c in (_E1_A, _E1_P, _E1_Q))
    x = torch.clamp_min(x, 1e-8)
    xs = torch.clamp_max(x, 1.0)
    small = (-torch.log(xs) + a[0] + xs * (a[1] + xs * (a[2] + xs *
             (a[3] + xs * (a[4] + xs * a[5])))))
    xl = torch.clamp_min(x, 1.0)
    num = xl ** 4 + p[0] * xl ** 3 + p[1] * xl ** 2 + p[2] * xl + p[3]
    den = xl ** 4 + q[0] * xl ** 3 + q[1] * xl ** 2 + q[2] * xl + q[3]
    large = torch.exp(-xl) / xl * (num / den)
    return torch.where(x <= 1.0, small, large).float()


def window_counts(n: int, w: int) -> np.ndarray:
    """How many of the w samples centred on each of n lie inside,
    float32."""
    idx = np.arange(n)
    cnt = np.minimum(idx + w - 1 - w // 2, n - 1) \
        - np.maximum(idx - w // 2, 0) + 1
    return cnt.astype(np.float32)


def moving_average(v: torch.Tensor, window: int, owner) -> torch.Tensor:
    """Centered moving average over window + 1 samples with edge-clamped
    counts (reference npmavg, arrays.cpp:1068-1092), the counts kept on
    ``owner``.  The sums are float32 sums of shifted windows
    (``unfold``), never a convolution, which the card could take in
    TF32."""
    n = v.shape[-1]
    w = window + 1
    vp = torch.nn.functional.pad(v.float().reshape(-1, n),
                                 (w // 2, w - 1 - w // 2))
    s = vp.unfold(-1, w, 1).sum(-1)
    cnt = device_const(owner, f"window counts {n} {w}",
                       lambda: window_counts(n, w), v.device)
    return (s / cnt).reshape(v.shape)


def forward_fill_zeros(sig: torch.Tensor) -> torch.Tensor:
    """Each zero bin takes the last nonzero bin's value before it, else 0
    (the zero-fix of logmmse.h:364-368, which the JAX package runs as a
    select recurrence along bins): a ``cummax`` of indices and a gather,
    exact."""
    n = sig.shape[-1]
    idx = torch.arange(n, device=sig.device)
    last = torch.cummax(torch.where(sig != 0.0, idx, -1), dim=-1).values
    filled = torch.gather(sig, -1, last.clamp_min(0))
    return torch.where(last >= 0, filled, torch.zeros_like(sig))


def linear_interpolate_holes(arr: torch.Tensor):
    """Fill zero-valued holes by linear interpolation between neighbours,
    clamping the edges (reference arrays.cpp:433-469).  Returns
    (filled, any_nonzero)."""
    n = arr.shape[-1]
    idx = torch.arange(n, device=arr.device)
    nz = arr != 0.0
    prev_i = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    next_i = -torch.cummax(torch.where(nz, -idx, -n).flip(-1),
                           dim=-1).values.flip(-1)
    prev_v = torch.gather(arr, -1, prev_i.clamp_min(0))
    next_v = torch.gather(arr, -1, next_i.clamp_max(n - 1))
    both = (prev_i >= 0) & (next_i < n)
    denom = torch.clamp_min(next_i - prev_i, 1).to(arr.dtype)
    interp = prev_v + (next_v - prev_v) * (idx - prev_i).to(arr.dtype) \
        / denom
    filled = torch.where(nz, arr, torch.where(
        both, interp, torch.where(prev_i >= 0, prev_v, next_v)))
    return filled, nz.any(-1)


def bg_buckets(dev_square: torch.Tensor):
    """The histogram's inputs (bgnoise.h:26-59): (bucket [..., n] int32,
    weight [..., n] float32, minn, width) — bucket =
    int(1000·(log10 d − min)/width) in the JAX package's order of
    operations, weight 0 on the erased bins."""
    mask = dev_square != ERASED_SAMPLE
    logf = torch.where(mask, torch.log10(torch.clamp_min(dev_square, 1e-30)),
                       torch.zeros_like(dev_square))
    minn = torch.where(mask, logf, math.inf).amin(-1)
    maxx = torch.where(mask, logf, -math.inf).amax(-1)
    width = torch.clamp_min(maxx - minn, 1e-12)
    bucket = NBUCKETS * (logf - minn[..., None]) / width[..., None]
    bucket = torch.clamp(bucket.to(torch.int32), 0, NBUCKETS - 1)
    return bucket, mask.float(), minn, width


def bg_noise_update(dev_square, last_noise, frame_count):
    """Histogram-mode background noise tracker (reference
    bgnoise.h:26-59): dev_square [..., nFFT] with ERASED_SAMPLE holes →
    (last_noise, frame_count + 1).  The mode is the first of the fullest
    buckets (``argmax``, as ``jnp.argmax``)."""
    do_update = (frame_count == 0) | (frame_count % SKIP_FRAMES == 0)
    bucket, w, minn, width = bg_buckets(dev_square)
    counts = torch.zeros(bucket.shape[:-1] + (NBUCKETS,), dtype=torch.float32,
                         device=bucket.device)
    counts.scatter_add_(-1, bucket.long(), w)
    mode = torch.argmax(counts, dim=-1)
    maxf = torch.pow(10.0, (mode.float() / NBUCKETS) * width + minn)
    new_noise = torch.where(last_noise == ERASED_SAMPLE, maxf,
                            0.9 * last_noise + 0.1 * maxf)
    last_noise = torch.where(do_update, new_noise, last_noise)
    return last_noise, frame_count + 1


RINGS = ("hist", "dev_hist")
HANDED_OVER = ("this LogMMSE state's rings were handed over to the state "
               "K14 returned (ops/logmmse.py:hand_over; K14 writes them in "
               "place): continue from that state")


def hand_over(st: dict) -> dict:
    """The rings of ``st`` for the state K14 returns: new tensors on the
    same storage, while ``st``'s own ring tensors are emptied and marked,
    so that ``st`` (or any state holding them) used again raises in
    ``check_rings`` and cannot read rings a later block has written."""
    out = {}
    for k in RINGS:
        t = st[k]
        out[k] = t.new_empty(0).set_(t)
        t.set_()
        t.handed_over = True
    return out


def check_rings(st: dict) -> None:
    """Raise if ``st``'s rings were handed over to a later state."""
    for k in RINGS:
        if getattr(st[k], "handed_over", False):
            raise RuntimeError(f"LogMMSE: {HANDED_OVER}")


class LogMMSE(Block):
    """Streaming log-MMSE NR over complex blocks (batched on leading axes).

    ``wideband`` selects the noise-floor detector; by default the audio
    branch where nFFT < 1200 (the reference's audioFrequency rule,
    logmmse.h:265)."""

    NOISE_FRAMES = 12  # initial sampling frames (if_nr.h:83, af_nr.h:298)

    def __init__(self, samplerate: float, wideband: Optional[bool] = None):
        self.samplerate = float(samplerate)
        slen = int(math.floor(0.02 * samplerate))
        if slen % 2 == 1:
            slen += 1
        self.Slen = slen
        self.len1 = slen // 2
        self.len2 = slen - self.len1
        self.nFFT = 2 * slen
        self.audio = (self.nFFT < 1200) if wideband is None \
            else (not wideband)
        self.H = 2000 if self.nFFT < 1000 else 200
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(slen) / (slen - 1))
        self.win = (win * self.len2 / win.sum()).astype(np.float32)
        self.aa = 0.98
        self.ksi_min = 10.0 ** (-25.0 / 10.0)
        self.in_multiple = self.len2
        self.ratio = Fraction(1, 1)
        self.erased = np.abs(np.arange(self.nFFT) - self.nFFT // 2) \
            < (self.nFFT * 15) // 100

    # ------------------------------------------------------------------
    def init_state(self, batch_shape=()):
        b = tuple(batch_shape)
        f32, c64 = torch.float32, torch.complex64
        return {
            "tail": torch.zeros(b + (self.Slen,), dtype=c64),
            "x_old": torch.zeros(b + (self.len1,), dtype=c64),
            "Xk_prev": torch.zeros(b + (self.nFFT,), dtype=f32),
            "has_prev": torch.zeros(b, dtype=torch.bool),
            "noise_mu2": torch.ones(b + (self.nFFT,), dtype=f32),
            "primed": torch.zeros(b, dtype=torch.bool),
            "hist": torch.zeros(b + (self.H, self.nFFT), dtype=f32),
            "dev_hist": torch.zeros(b + (self.H, self.nFFT), dtype=f32),
            "sums": torch.zeros(b + (self.nFFT,), dtype=f32),
            "devs": torch.zeros(b + (self.nFFT,), dtype=f32),
            # frame counters advance identically for every channel
            "count": torch.zeros((), dtype=torch.int32),
            "pos": torch.zeros((), dtype=torch.int32),
            "mindb": torch.zeros(b, dtype=f32),
            "maxdb": torch.zeros(b, dtype=f32),
            "stable": torch.zeros(b, dtype=torch.bool),
            "generation": torch.zeros((), dtype=torch.int32),
            "bg_last_noise": torch.full(b, ERASED_SAMPLE, dtype=f32),
            "bg_frame_count": torch.zeros((), dtype=torch.int32),
        }

    def init_params(self):
        return {"hold": torch.tensor(False)}

    # ------------------------------------------------------------------
    def _frames(self, ext: torch.Tensor, F: int) -> torch.Tensor:
        """[..., T+Slen] → [..., F, Slen] windows at stride len2 (a view)."""
        return ext.unfold(-1, self.Slen, self.len2)[..., :F, :]

    def _spectra(self, frames: torch.Tensor):
        """frames [..., F, Slen] → (spec [..., F, nFFT], |spec| with its
        zero bins forward-filled)."""
        win = device_const(self, "win", self.win, frames.device)
        spec = torch.fft.fft(frames * win, n=self.nFFT, dim=-1)
        return spec, forward_fill_zeros(spec.abs().float())

    def _push_history(self, st: dict, sigs: torch.Tensor, hold) -> dict:
        """The sliding-window bookkeeping of each frame (reference
        add_noise_history, logmmse.h:117-140), into rings copied once."""
        H = self.H
        hist = st["hist"].clone()
        dev_hist = st["dev_hist"].clone()
        sums, devs = st["sums"], st["devs"]
        count, pos = st["count"], st["pos"]
        ax = hist.dim() - 2
        for f in range(sigs.shape[-2]):
            noise = sigs[..., f, :]
            slot = pos.reshape(1).long()
            old = hist.index_select(ax, slot).squeeze(ax)
            old_dev = dev_hist.index_select(ax, slot).squeeze(ax)
            full = count >= H
            zero = torch.zeros_like(noise)
            sums2 = sums + noise - torch.where(full, old, zero)
            count2 = torch.where(full, count, count + 1)
            navg = sums2 / count2.float()
            diff = (noise - navg) ** 2
            devs2 = devs + diff - torch.where(full, old_dev, zero)
            pos2 = (pos + 1) % H
            if hold is not None:
                noise = torch.where(hold, old, noise)
                diff = torch.where(hold, old_dev, diff)
                sums2 = torch.where(hold, sums, sums2)
                devs2 = torch.where(hold, devs, devs2)
                count2 = torch.where(hold, count, count2)
                pos2 = torch.where(hold, pos, pos2)
            hist.index_copy_(ax, slot, noise.unsqueeze(ax))
            dev_hist.index_copy_(ax, slot, diff.unsqueeze(ax))
            sums, devs, count, pos = sums2, devs2, count2, pos2
        st.update(hist=hist, dev_hist=dev_hist, sums=sums, devs=devs,
                  count=count, pos=pos)
        return st

    # ------------------------------------------------------------------
    def _update_noise_mu2(self, st: dict, hold) -> dict:
        """Once-per-block noise PSD refresh (logmmse.h:152-283)."""
        nframes = st["count"]
        gate = nframes > 100
        if hold is not None:
            gate = gate & ~hold
        if self.audio:
            k = 12
            offs = (st["pos"] - k + torch.arange(
                k, device=nframes.device, dtype=torch.int32)) % self.H
            hist = st["hist"]
            last = hist.index_select(hist.dim() - 2, offs.long())
            lower = last.mean(-2)
            tnm = lower * lower
            tsm = moving_average(tnm, 6, self)
            tmin, tmax = tsm.amin(-1), tsm.amax(-1)
            accept = gate & (st["generation"] > 0) & \
                (tmin + tmax < st["mindb"] + st["maxdb"])
            noise_mu2 = torch.where(accept[..., None], tnm, st["noise_mu2"])
            mindb = torch.where(accept, tmin, st["mindb"])
            maxdb = torch.where(accept, tmax, st["maxdb"])
            stable = st["stable"] | accept
            init0 = gate & (st["generation"] == 0) & ~st["stable"]
            cur = moving_average(st["noise_mu2"], 6, self)
            mindb = torch.where(init0, cur.amin(-1), mindb)
            maxdb = torch.where(init0, cur.amax(-1), maxdb)
            st.update(noise_mu2=noise_mu2, mindb=mindb, maxdb=maxdb,
                      stable=stable,
                      generation=st["generation"] + gate.to(torch.int32))
            return st

        # wideband branch
        n = torch.clamp_min(nframes.float(), 1.0)
        navg = st["sums"] / n
        hi = st["devs"] / n
        dev_sq = hi * hi
        erased = device_const(self, "erased", self.erased, dev_sq.device)
        dev_sq = torch.where(erased, ERASED_SAMPLE, dev_sq)
        last_noise, fc = bg_noise_update(
            dev_sq, st["bg_last_noise"], st["bg_frame_count"])
        nmu2 = torch.where(dev_sq < last_noise[..., None], navg * navg,
                           torch.zeros_like(navg))
        filled, any_nz = linear_interpolate_holes(nmu2)
        ok = gate & any_nz
        st.update(noise_mu2=torch.where(ok[..., None], filled,
                                        st["noise_mu2"]),
                  bg_last_noise=torch.where(gate, last_noise,
                                            st["bg_last_noise"]),
                  bg_frame_count=torch.where(gate, fc,
                                             st["bg_frame_count"]))
        return st

    # ------------------------------------------------------------------
    def _gains(self, st: dict, sigs: torch.Tensor):
        """Decision-directed ξ recursion over frames → hw [..., F, nFFT]
        (logmmse.h:376-397)."""
        aa = float(np.float32(self.aa))
        one_m_aa = float(np.float32(1.0) - np.float32(self.aa))
        ksi_min = float(np.float32(self.ksi_min))
        mu2 = torch.clamp_min(st["noise_mu2"], 1e-30)
        xk_prev, has_prev = st["Xk_prev"], st["has_prev"]
        hws = []
        for f in range(sigs.shape[-2]):
            sig = sigs[..., f, :]
            gammak = torch.clamp_max(sig * sig / mu2, 40.0)
            gm = torch.clamp_min(gammak - 1.0, 0.0)
            ksi_first = one_m_aa * gm + aa
            ksi_dd = torch.clamp_min(aa * xk_prev / mu2 + one_m_aa * gm,
                                     ksi_min)
            ksi = torch.where(has_prev[..., None], ksi_dd, ksi_first)
            A = ksi / (1.0 + ksi)
            hw = A * torch.exp(0.5 * expn_e1(A * gammak))
            sig_hw = sig * hw
            xk_prev = sig_hw * sig_hw
            has_prev = torch.ones_like(has_prev)
            hws.append(hw)
        st.update(Xk_prev=xk_prev, has_prev=has_prev)
        return st, torch.stack(hws, dim=-2)

    # ------------------------------------------------------------------
    def apply(self, params, state, x):
        check_rings(state)
        if x.shape[-1] % self.len2:
            raise ValueError(
                f"LogMMSE: block length {x.shape[-1]} must be a multiple "
                f"of len2={self.len2}")
        hold = params.get("hold") if params else None
        if hold is not None:
            hold = torch.as_tensor(hold).to(x.device)
        T = x.shape[-1]
        F = T // self.len2
        st = dict(state)
        ext = torch.cat([st["tail"], x.to(torch.complex64)], dim=-1)
        st["tail"] = ext[..., T:]
        spec, sig = self._spectra(self._frames(ext, F))
        # the noise PSD refresh reads the history as of the previous block
        st = self._update_noise_mu2(st, hold)
        st, hw = logmmse_frames(self, st, sig, hold)
        xi = torch.fft.ifft(hw.to(torch.complex64) * spec, dim=-1)
        head = xi[..., :self.len1]
        tail = xi[..., self.len1:self.Slen]
        prev_tail = torch.cat([st["x_old"].unsqueeze(-2), tail[..., :-1, :]],
                              dim=-2)
        out = head + prev_tail
        st["x_old"] = tail[..., -1, :]
        return out.reshape(out.shape[:-2] + (F * self.len1,)), st

    # ------------------------------------------------------------------
    def prime(self, state, x0):
        """Initial noise sampling (reference logmmse_sample,
        logmmse.h:286-339): NOISE_FRAMES non-overlapping Slen frames of
        ``x0`` seed noise_mu2 and the history (through
        ``logmmse_frames``: on the card K14, one launch); Xk_prev and
        has_prev stay as they were."""
        need = self.NOISE_FRAMES * self.Slen
        assert x0.shape[-1] >= need, (x0.shape, need)
        frames = x0[..., :need].to(torch.complex64).reshape(
            x0.shape[:-1] + (self.NOISE_FRAMES, self.Slen))
        _, sig = self._spectra(frames)
        # the history half of K14 (its gains unread): the plain
        # _push_history's ring, sums and counters bit for bit
        pushed, _ = logmmse_frames(self, dict(state), sig, None)
        st = dict(state)
        st.update({k: pushed[k] for k in
                   RINGS + ("sums", "devs", "count", "pos")})
        noise_mean = sig.mean(-2)
        if not self.audio:
            noise_mean = moving_average(noise_mean, 120, self)
        st["noise_mu2"] = noise_mean * noise_mean
        st["primed"] = torch.ones_like(st["primed"])
        return st


def logmmse_frames_ref(core: LogMMSE, st: dict, sig: torch.Tensor, hold):
    """Plain K14: each frame's history-ring update, then the ξ recursion
    over the frames → (state', hw [..., F, nFFT]).  ``st`` is not
    modified (its rings are copied)."""
    st = core._push_history(dict(st), sig, hold)
    return core._gains(st, sig)


@_build.counted
def logmmse_frames_kernel(core: LogMMSE, st: dict, sig: torch.Tensor, hold):
    """K14 on the card (csrc/logmmse.cu), one launch; the contract of
    ``logmmse_frames_ref``, but the rings are not copied: K14 writes the
    block's F slots in place, the returned state holds the rings, and
    ``st``'s are handed over (``hand_over``): ``st`` used again raises."""
    check_rings(st)
    dev = sig.device
    batch = tuple(sig.shape[:-2])
    F, N = sig.shape[-2:]
    H, B = core.H, int(np.prod(batch, dtype=np.int64))
    if N != core.nFFT:
        raise ValueError(f"K14: {N} bins, expected nFFT={core.nFFT}")
    f32, bvec = torch.float32, batch + (N,)
    hw = torch.empty(batch + (F, N), dtype=f32, device=dev)
    out = {k: torch.empty_like(st[k]) for k in
           ("Xk_prev", "sums", "devs", "count", "pos", "has_prev")}
    if hold is not None:
        hold = _build.check(hold, "K14 hold", torch.bool, (), dev)
    one_m_aa = float(np.float32(1.0) - np.float32(core.aa))
    _build.launch(
        "sdr_logmmse_frames", dev, _build.check(sig, "K14 frames", f32,
                                                batch + (F, N), dev),
        _build.check(st["noise_mu2"], "K14 noise_mu2", f32, bvec, dev),
        _build.check(st["Xk_prev"], "K14 Xk_prev", f32, bvec, dev),
        _build.check(st["has_prev"], "K14 has_prev", torch.bool, batch, dev),
        _build.check(st["hist"], "K14 hist", f32, batch + (H, N), dev),
        _build.check(st["dev_hist"], "K14 dev_hist", f32, batch + (H, N),
                     dev),
        _build.check(st["sums"], "K14 sums", f32, bvec, dev),
        _build.check(st["devs"], "K14 devs", f32, bvec, dev),
        _build.check(st["count"], "K14 count", torch.int32, (), dev),
        _build.check(st["pos"], "K14 pos", torch.int32, (), dev),
        hold, B, F, N, H, float(np.float32(core.aa)), one_m_aa,
        float(np.float32(core.ksi_min)), hw.data_ptr(),
        out["Xk_prev"].data_ptr(), out["sums"].data_ptr(),
        out["devs"].data_ptr(), out["count"].data_ptr(),
        out["pos"].data_ptr(), out["has_prev"].data_ptr())
    new = dict(st)
    new.update(out, **hand_over(st))
    return new, hw


def logmmse_frames(core: LogMMSE, st: dict, sig: torch.Tensor, hold):
    """K14 dispatch: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not sig.is_cuda:
        return logmmse_frames_ref(core, st, sig, hold)
    return logmmse_frames_kernel(core, st, sig, hold)


class IFNRLogMMSE(Block):
    """Baseband (IF) noise reduction preprocessor: wideband LogMMSE with
    the reference's ×4 output gain (if_nr.h:99-104)."""

    def __init__(self, samplerate: float):
        self.core = LogMMSE(samplerate, wideband=True)
        self.in_multiple = self.core.in_multiple

    def init_state(self, batch_shape=()):
        return self.core.init_state(batch_shape)

    def init_params(self):
        return self.core.init_params()

    def prime(self, state, x0):
        return self.core.prime(state, x0)

    def apply(self, params, state, x):
        y, st = self.core.apply(params, state, x)
        return y * 4.0, st


class AFNRLogMMSE(Block):
    """Audio noise reduction: audio-branch LogMMSE with a 5-sample moving
    average (af_nr.h:208-345, SMAStream<5>) on K8."""

    SMA = 5

    def __init__(self, samplerate: float = 24000.0):
        self.core = LogMMSE(samplerate, wideband=False)
        self.in_multiple = self.core.in_multiple
        self.taps = np.ones(self.SMA, np.float32) / self.SMA

    def init_state(self, batch_shape=()):
        st = self.core.init_state(batch_shape)
        st["sma"] = torch.zeros(tuple(batch_shape) + (self.SMA - 1,),
                                dtype=torch.complex64)
        return st

    def init_params(self):
        return self.core.init_params()

    def prime(self, state, x0):
        st = dict(state)
        st.update(self.core.prime(
            {k: v for k, v in state.items() if k != "sma"}, x0))
        return st

    def apply(self, params, state, x):
        core_state = {k: v for k, v in state.items() if k != "sma"}
        y, st = self.core.apply(params, core_state, x)
        sm, st["sma"] = fir_rows(y.contiguous(), state["sma"].contiguous(),
                                 device_taps(self, self.taps, y.device), 1, 1)
        return sm, st
