"""OM-LSA speech enhancement with MCRA noise estimation (counterpart of
sdrplusplusbrown_tpu/ops/omlsa.py; reference
misc_modules/noise_reduction_logmmse/src/omlsa_mcra/*, Cohen & Berdugo
2001/2002), float32:

  * STFT at 50 % overlap with a sqrt-Hann window at analysis and
    synthesis (their product, the periodic Hann, overlap-adds to 1);
  * MCRA noise PSD: the frequency-smoothed periodogram, its recursive
    smoothing S, the running minimum over L frames (two buffers), the
    speech-presence indicator S/Smin > δ, its smoothed probability p' and
    the noise update λ_d ← α_d' λ_d + (1−α_d') |Y|², α_d' = α_d +
    (1−α_d) p';
  * the OM-LSA gain: decision-directed ξ, G_H1 = ξ/(1+ξ)·exp(½E1(v)),
    the presence probability p from the a-priori ratio, G = G_H1^p ·
    G_min^(1−p).

All frames of a block go through one ``torch.fft.rfft``; the MCRA state
and the gain run in a Python loop of torch ops over the block's frames.
The JAX package computes all of it outside any Pallas kernel.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from ..runtime.block import Block, device_const
from .logmmse import expn_e1


def _f32(v: float) -> float:
    """``v`` rounded to float32 (the JAX package's jnp.float32 scalars)."""
    return float(np.float32(v))


class OMLSA(Block):
    def __init__(self, samplerate: float, frame_len: int | None = None,
                 g_min: float = 10.0 ** (-25.0 / 20.0),
                 alpha: float = 0.92, alpha_d: float = 0.85,
                 alpha_s: float = 0.8, alpha_p: float = 0.2,
                 delta: float = 5.0, min_window_frames: int = 60):
        self.samplerate = float(samplerate)
        n = frame_len or (1 << int(round(math.log2(0.02 * samplerate))))
        self.N = int(n)
        self.hop = self.N // 2
        win = np.hanning(self.N + 1)[:-1]
        self.win = np.sqrt(win).astype(np.float32)
        self.g_min = float(g_min)
        self.alpha = float(alpha)
        self.alpha_d = float(alpha_d)
        self.alpha_s = float(alpha_s)
        self.alpha_p = float(alpha_p)
        self.delta = float(delta)
        self.L = int(min_window_frames)
        self.in_multiple = self.hop
        self.ratio = Fraction(1, 1)

    def init_state(self, batch_shape=()):
        b = tuple(batch_shape)
        F = self.N // 2 + 1
        f32 = torch.float32
        return {
            "tail": torch.zeros(b + (self.N,), dtype=f32),
            "ola": torch.zeros(b + (self.hop,), dtype=f32),
            "S": torch.zeros(b + (F,), dtype=f32),
            "Smin": torch.full(b + (F,), 1e10, dtype=f32),
            "Stmp": torch.full(b + (F,), 1e10, dtype=f32),
            "lambda_d": torch.full(b + (F,), 1e-6, dtype=f32),
            "p_prev": torch.zeros(b + (F,), dtype=f32),
            "xi_prev": torch.full(b + (F,), 1.0, dtype=f32),
            "G_prev": torch.ones(b + (F,), dtype=f32),
            "frame_count": torch.zeros((), dtype=torch.int32),
            "primed": torch.zeros(b, dtype=torch.bool),
        }

    @staticmethod
    def _freq_smooth(p: torch.Tensor) -> torch.Tensor:
        """[0.25, 0.5, 0.25] across bins, the edges repeated."""
        pp = torch.cat([p[..., :1], p, p[..., -1:]], dim=-1)
        return 0.25 * pp[..., :-2] + 0.5 * pp[..., 1:-1] + 0.25 * pp[..., 2:]

    def apply(self, params, state, x):
        if x.shape[-1] % self.hop:
            raise ValueError(
                f"OMLSA: block length {x.shape[-1]} must be a multiple of "
                f"hop={self.hop}")
        st = dict(state)
        T = x.shape[-1]
        Fn = T // self.hop
        win = device_const(self, "win", self.win, x.device)
        ext = torch.cat([st["tail"], x.float()], dim=-1)
        st["tail"] = ext[..., T:]
        frames = ext.unfold(-1, self.N, self.hop)[..., :Fn, :] * win
        spec = torch.fft.rfft(frames, dim=-1)
        ps = spec.abs() ** 2

        a, ad, as_, ap = (_f32(v) for v in (self.alpha, self.alpha_d,
                                            self.alpha_s, self.alpha_p))
        # the JAX package's (1 − α) of a float32 α, in float32
        a_c, ad_c, as_c, ap_c = (float(np.float32(1) - np.float32(v))
                                 for v in (a, ad, as_, ap))
        delta, gmin = _f32(self.delta), _f32(self.g_min)
        L = self.L
        S, Smin, Stmp, lam = st["S"], st["Smin"], st["Stmp"], st["lambda_d"]
        p_prev, xi_prev, G, fc = (st["p_prev"], st["xi_prev"], st["G_prev"],
                                  st["frame_count"])
        gains = []
        for f in range(Fn):
            p = ps[..., f, :]
            S = as_ * S + as_c * self._freq_smooth(p)
            Smin2 = torch.minimum(Smin, S)
            Stmp2 = torch.minimum(Stmp, S)
            wrap = (fc % L) == (L - 1)
            Smin = torch.where(wrap, Stmp2, Smin2)
            Stmp = torch.where(wrap, S, Stmp2)
            # speech presence from the minima ratio, MCRA's smoothed
            # presence probability and the noise update
            I = (S / torch.clamp_min(Smin, 1e-20) > delta).float()
            p_prev = ap * p_prev + ap_c * I
            ad_eff = ad + ad_c * p_prev
            lam = ad_eff * lam + (1 - ad_eff) * p
            # the OM-LSA gain, decision-directed on G²·γ of the last frame
            gamma = torch.clamp_max(p / torch.clamp_min(lam, 1e-20), 40.0)
            gm = torch.clamp_min(gamma - 1.0, 0.0)
            xi = torch.clamp_min(a * xi_prev + a_c * gm, 1e-6)
            v = torch.clamp(xi * gamma / (1.0 + xi), 1e-8, 50.0)
            G_h1 = (xi / (1.0 + xi)) * torch.exp(0.5 * expn_e1(v))
            q = torch.clamp(1.0 - p_prev, 0.05, 0.95)
            ratio = (q / (1.0 - q)) * (1.0 + xi) * torch.exp(-v)
            p_post = 1.0 / (1.0 + ratio)
            G = (G_h1 ** p_post) * torch.pow(gmin, 1.0 - p_post)
            xi_prev = (G_h1 ** 2) * gamma
            fc = fc + 1
            gains.append(G)
        st.update(S=S, Smin=Smin, Stmp=Stmp, lambda_d=lam, p_prev=p_prev,
                  xi_prev=xi_prev, G_prev=G, frame_count=fc)

        out_spec = spec * torch.stack(gains, dim=-2).to(spec.dtype)
        frames_out = torch.fft.irfft(out_spec, n=self.N, dim=-1) * win
        head = frames_out[..., :self.hop]
        tail = frames_out[..., self.hop:]
        prev = torch.cat([st["ola"].unsqueeze(-2), tail[..., :-1, :]],
                         dim=-2)
        out = (head + prev).reshape(x.shape[:-1] + (Fn * self.hop,))
        st["ola"] = tail[..., -1, :]
        return out.float(), st
