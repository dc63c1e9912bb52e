"""Device-side EFFT lossy baseband compression (counterpart of
sdrplusplusbrown_tpu/ops/efft_jax.py, PyTorch ops, no kernel of its own).

The masking and companding of ops/efft.py (reference:
core/src/dsp/compression/experimental_fft_compressor.h) on the device
that holds the baseband, so that only masked frames cross a link: the
device feed (io/feed.py) re-expands them the other way.

Same state as the JAX block — the MIN_RECENTS − 1 newest rows of the
clean spectrum (complex64) and of the clean and windowed dB spectra
(float32), the frame ``count`` (int32) and the allowance EMA
``prev_allowance`` (float32) — and the same outputs, ``(emits [F, n]
complex64, readys [F] bool)``.  The JAX block walks the F frames of a
call in a ``lax.scan``; here a call is one pass over all of them:

  * both FFTs (plain and windowed) of every frame in one batched call;
  * each frame's R-frame means as sums over a sliding window of the rows
    ``[state | new]``;
  * ``_filter_signal``'s moving averages, hole fills and percentiles
    batched over ``[F, n]`` (``torch.quantile``, linear, the rule of
    ``jnp.percentile``);
  * only the allowance EMA, gated by ``ready``, walks the frames in
    order: a recurrence of F scalars on the device (two launches a
    frame, no host sync).

Moving averages take their running sum in float64: in float32 the sum
of a 65 536-bin dB spectrum rounds by ~0.5 dB-bins, and the card's scan
and the host's round differently, which would move the mask.  The
result is cast back to the JAX block's float32.
"""

from __future__ import annotations

import torch

from ..runtime.block import Block, device_const, entry_device
from .efft import EFFTCompressor


def centered_sma(x: torch.Tensor, w: int) -> torch.Tensor:
    """Centered moving average along the last axis with edge-clamped
    counts (``np.convolve(x, ones(w), 'same') / counts``, as
    efft_jax.centered_sma_j computes it from a running sum)."""
    w = max(int(w), 1)
    n = x.shape[-1]
    hi_off = (w - 1) // 2
    lo_off = w - 1 - hi_off
    c = torch.nn.functional.pad(torch.cumsum(x, -1, dtype=torch.float64),
                                (1, 0))
    idx = torch.arange(n, device=x.device)
    hi = (idx + hi_off + 1).clamp(0, n)
    lo = (idx - lo_off).clamp(0, n)
    s = c[..., hi] - c[..., lo]
    return (s / (hi - lo)).to(x.dtype)


def moving_variance(x: torch.Tensor, w: int) -> torch.Tensor:
    """SMA((x − SMA(x))²), the reference's movingVariance."""
    d = x - centered_sma(x, w)
    return centered_sma(d * d, w)


def interpolate_holes(a: torch.Tensor) -> torch.Tensor:
    """Linear interpolation across zero-valued holes along the last axis,
    edge-clamped (efft_jax.interpolate_holes_j's arithmetic: the previous
    and next nonzero index by two cumulative maxima, then a gather)."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    nz = a != 0.0
    prev = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    nxt = -torch.cummax(torch.where(nz, -idx, -n).flip(-1),
                        dim=-1).values.flip(-1)
    has_prev = prev >= 0
    has_next = nxt < n
    pv = torch.gather(a, -1, prev.clamp(0, n - 1))
    nv = torch.gather(a, -1, nxt.clamp(0, n - 1))
    span = torch.clamp_min((nxt - prev).to(a.dtype), 1.0)
    t = (idx - prev).to(a.dtype) / span
    interp = pv + (nv - pv) * t
    out = torch.where(has_prev & has_next, interp,
                      torch.where(has_prev, pv, torch.where(has_next, nv, a)))
    return torch.where(nz, a, out)


class EFFTCompressorDevice(Block):
    """Batched EFFT on the device: x [T] → ((emits [F, n] complex64, readys
    [F] bool), state), frame for frame the semantics of
    ops/efft.EFFTCompressor.process: each emitted frame is the
    (MIN_RECENTS − 1)-delayed clean spectrum, masked by the averaged
    spectra's noise-floor test and ∜-companded.  ``in_multiple =
    fft_size``.  Params and state live on ``device`` (CUDA unless the
    caller asks for the CPU); only the input moves."""

    def __init__(self, samplerate: float, slice_msec: int = 50,
                 loss_rate: float = 4.0, device="cuda"):
        self.device = entry_device(device)
        ref = EFFTCompressor(samplerate, slice_msec, loss_rate)
        self.samplerate = float(samplerate)
        self.fft_size = ref.fft_size
        self.window_np = ref.window.astype("float32")
        self.large_tick = ref.large_tick
        self.window_power_db = ref.window_power_db
        self.loss_rate = float(loss_rate)
        self.R = ref.MIN_RECENTS
        self.NOISE_NPOINTS = ref.NOISE_NPOINTS
        self.mask_sma = max(int(ref.SIGNAL_WIDTH / 8), 1)
        self.in_multiple = self.fft_size

    def init_state(self, batch_shape=()):
        assert batch_shape == ()
        n, R, dev = self.fft_size, self.R, self.device
        return {
            "clean_freq": torch.zeros((R - 1, n), dtype=torch.complex64,
                                      device=dev),
            "clean_mag": torch.zeros((R - 1, n), dtype=torch.float32,
                                     device=dev),
            "win_mag": torch.zeros((R - 1, n), dtype=torch.float32,
                                   device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "prev_allowance": torch.zeros((), dtype=torch.float32,
                                          device=dev),
        }

    def _db(self, spec: torch.Tensor) -> torch.Tensor:
        n = self.fft_size
        p = spec.abs() ** 2 / (n * n)
        return 10.0 * torch.log10(torch.clamp_min(p, 1e-30))

    def apply(self, params, state, x):
        n, R = self.fft_size, self.R
        x = x.to(self.device, torch.complex64)
        assert x.shape[-1] % n == 0, (x.shape, n)
        frames = x.reshape(-1, n)
        F = frames.shape[0]
        win = device_const(self, "window", self.window_np, self.device)
        # both FFTs of every frame in one batched call
        specs = torch.fft.fftshift(torch.fft.fft(
            torch.cat([frames, frames * win]), dim=-1), dim=-1)
        mags = self._db(specs)
        cf = torch.cat([state["clean_freq"], specs[:F]])
        cm = torch.cat([state["clean_mag"], mags[:F]])
        wm = torch.cat([state["win_mag"], mags[F:]])
        # frame f averages rows f .. f + R − 1 of [state | new]
        wavg = (wm.unfold(0, R, 1).sum(-1, dtype=torch.float64) / R
                ).float()
        cavg = (cm.unfold(0, R, 1).sum(-1, dtype=torch.float64) / R
                ).float()
        emit = cf[:F]
        count = state["count"] + torch.arange(
            1, F + 1, dtype=torch.int32, device=self.device)
        ready = count >= R

        # _filter_signal (ops/efft.py), every frame at once but the EMA
        mvar = moving_variance(wavg, self.NOISE_NPOINTS)
        new01 = self.loss_rate * torch.quantile(
            mvar, 0.15, dim=-1, interpolation="linear") * 0.1
        a = state["prev_allowance"]
        allow = []
        for f in range(F):
            a = torch.where(ready[f], torch.add(new01[f], a, alpha=0.9), a)
            allow.append(a)
        allowance = torch.stack(allow)[:, None]

        cma = centered_sma(wavg, self.large_tick)
        cma = torch.where(mvar > allowance, 0.0, cma)
        cma = interpolate_holes(cma)
        cma = centered_sma(cma, self.large_tick)
        cmax = centered_sma(cma, 5 * self.large_tick)
        diff = (cma - cmax).abs()
        cmax_allow = torch.quantile(diff, 0.15, dim=-1, keepdim=True,
                                    interpolation="linear")
        cma = torch.where(diff > cmax_allow, 0.0, cma)
        cma = interpolate_holes(cma)
        cma = centered_sma(cma, self.large_tick)

        floor = cma - self.window_power_db
        mask = (cavg > floor + allowance).float()
        mask = centered_sma(mask, self.mask_sma)
        emit = torch.where(mask == 0.0, 0.0, emit)

        # ∜ companding
        amp = emit.abs()
        emit = torch.where(amp > 0, emit * amp ** 0.25
                           / torch.clamp_min(amp, 1e-30), emit)

        new_state = {"clean_freq": cf[F:], "clean_mag": cm[F:],
                     "win_mag": wm[F:],
                     "count": torch.clamp_max(count[-1], 1 << 30),
                     "prev_allowance": allowance[-1, 0]}
        return (emit, ready), new_state


def efft_decompress(frames: torch.Tensor) -> torch.Tensor:
    """[F, n] companded frames → [F·n] time-domain complex64 on the
    frames' device (efft_jax.efft_decompress_j)."""
    amp = frames.abs()
    f = torch.where(amp > 0, frames * amp ** 4
                    / torch.clamp_min(amp, 1e-30), frames)
    td = torch.fft.ifft(torch.fft.ifftshift(f, dim=-1), dim=-1)
    return td.reshape(-1).to(torch.complex64)
