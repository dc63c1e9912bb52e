#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``Radio.apply_shared`` on the WFM-8
configuration (one 2.4 MS/s wideband, 8 stereo WFM VFOs, a 65 536-bin
spectrum at 20 fps, 240 000-sample steps) — through its four hand-written
CUDA kernels, which it first builds from ``sdrplusplusbrown_tpu_torch/csrc``.
Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build and its time;
  3. each kernel against its plain PyTorch version on the same inputs, at
     the main path's shapes on a stereo FM signal, float32 handoff; both
     timed with CUDA events;
  4. three consecutive steps with a retune before the third, in the
     production bf16 handoff: every kernel launched, finite outputs, the
     audio oracles (tone SNR, stereo separation), spectrum peaks on the
     carriers, and bf16 audio within 45 dB of the float32 run;
  5. the step rate on bench-style noise input.

The next-to-last line is a JSON report of the kernels; the last line,
printed only when every phase passed, is the device JSON.  Without a CUDA
device, or without the package beside it, the script exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

FS = 2_400_000.0
C = 8
FFT = 65_536
STEP = 240_000
OFFSETS = np.linspace(-1.0e6, 1.0e6, C)
RETUNE = OFFSETS + np.array([0, 40e3, -25e3, 0, 10e3, 0, -60e3, 0])
TONE_HZ = 1000.0


def fail(msg: str):
    raise RuntimeError(msg)


def stereo_wideband(n: int, offsets) -> np.ndarray:
    """One stereo FM broadcast (1 kHz tone in L only, 19 kHz pilot) on
    every carrier offset, plus a little noise."""
    t = np.arange(n) / FS
    tone = np.sin(2 * np.pi * TONE_HZ * t)
    mpx = (0.45 * tone + 0.1 * np.sin(2 * np.pi * 19_000 * t)
           + 0.45 * tone * (-np.cos(2 * np.pi * 38_000 * t)))
    base = np.exp(1j * 2 * np.pi * np.cumsum(75_000 * mpx) / FS)
    x = np.zeros(n, np.complex128)
    for o in offsets:
        x += base * np.exp(2j * np.pi * o * t)
    rng = np.random.default_rng(7)
    x = x / len(offsets) + 1e-3 * (rng.standard_normal(n)
                                   + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def snr_db(ref, got) -> float:
    ref = ref.double()
    err = got.double() - ref
    return float(10 * np.log10(float((ref ** 2).mean())
                               / max(float((err ** 2).mean()), 1e-300)))


def event_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sdrplusplusbrown_tpu_torch  # noqa: F401  (fails outside the repo)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    drive(torch.device("cuda", 0), card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive(dev, card: str) -> None:
    """Phases 2-5 on ``dev``; raises on the first failure."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import fft_kernel as k4
    from sdrplusplusbrown_tpu_torch.ops import mono_frontend as k1
    from sdrplusplusbrown_tpu_torch.ops import precision
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel as k23
    from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())

    radio = Radio(FS, DEMOD_WFM)
    spec = SpectrumPath(FS, fft_size=FFT, fft_rate=20.0)
    g = int(np.lcm(radio.in_multiple, spec.in_multiple))
    T = (STEP + g - 1) // g * g
    x = stereo_wideband(3 * T, OFFSETS)
    blocks = [(torch.from_numpy(x[b * T:(b + 1) * T].real.copy()).to(dev),
               torch.from_numpy(x[b * T:(b + 1) * T].imag.copy()).to(dev))
              for b in range(3)]

    def run3(handoff: str):
        precision.set_handoff_dtype(handoff)
        st = radio.init_state_shared(C)
        outs = []
        for b, xb in enumerate(blocks):
            params = radio.make_params_shared(OFFSETS if b < 2 else RETUNE)
            (audio, spectra), st = radio.apply_shared(params, st, xb,
                                                      spectrum=spec)
            outs.append((audio, spectra))
        torch.cuda.synchronize()
        return outs

    # ---- 3. kernels against their plain versions --------------------------
    # record each kernel's arguments (the last of the three steps, state
    # settled), then run kernel and plain version on exactly those tensors
    kernels = {"K1": (k1, "mono_frontend"), "K2": (k23, "wfm_demod"),
               "K3": (k23, "mpx_audio_poly"), "K4": (k4, "spectrum_frames_db")}
    captured = {}
    originals = {}
    for tag, (mod, name) in kernels.items():
        orig = getattr(mod, name + "_kernel")
        originals[tag] = orig

        def rec(*args, _tag=tag, _orig=orig):
            captured[_tag] = args
            return _orig(*args)
        setattr(mod, name + "_kernel", rec)
    try:
        ref32 = run3("float32")
    finally:
        for tag, (mod, name) in kernels.items():
            setattr(mod, name + "_kernel", originals[tag])

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    source = {"K1": ("sdrplusplusbrown_tpu_torch/csrc/mono_frontend.cu",
                     "sdrplusplusbrown_tpu/ops/mono_frontend.py:123"),
              "K2": ("sdrplusplusbrown_tpu_torch/csrc/wfm_demod.cu",
                     "sdrplusplusbrown_tpu/ops/wfm_kernel.py:47"),
              "K3": ("sdrplusplusbrown_tpu_torch/csrc/mpx_poly.cu",
                     "sdrplusplusbrown_tpu/ops/wfm_kernel.py:418"),
              "K4": ("sdrplusplusbrown_tpu_torch/csrc/spectrum_fft.cu",
                     "sdrplusplusbrown_tpu/ops/pallas_fft.py:253")}
    report = {}
    for tag, (mod, name) in kernels.items():
        args = captured[tag]
        kern = getattr(mod, name + "_kernel")
        ref = getattr(mod, name + "_ref")
        got = kern(*args)
        want = ref(*args)
        torch.cuda.synchronize()
        if tag in ("K1", "K2"):
            got, want = got[0], want[0]
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            fail(f"{tag}: non-finite kernel output")
        if tag == "K4":
            pk = want.max(dim=-1, keepdim=True).values
            d = (got - want).abs()
            e60 = float(d[want > pk - 60].max())
            e80 = float(d[want > pk - 80].max())
            agree = f"{e60:.2e} dB within 60 dB, {e80:.2e} within 80 dB"
            ok = e60 <= 0.01 and e80 <= 0.1
        else:
            s = snr_db(want, got)
            bound = 80.0 if tag == "K1" else 70.0
            agree = f"{s:.1f} dB SNR (bound {bound:.0f})"
            ok = s >= bound
        ms = event_ms(lambda: kern(*args))
        plain_ms = event_ms(lambda: ref(*args))
        print(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"max|err| {err:.3e}, {agree} [{card}]")
        if not ok:
            fail(f"{tag}: kernel disagrees with its plain version: {agree}")
        report[tag] = {"name": name, "route": "cuda", "source": source[tag][0],
                       "replaces": source[tag][1], "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms}

    # ---- 4. the main path, production bf16 handoff ------------------------
    for tag, (mod, name) in kernels.items():
        getattr(mod, name + "_kernel").launches = 0
    outs = run3("bf16")
    for tag, (mod, name) in kernels.items():
        n = getattr(mod, name + "_kernel").launches
        report[tag]["launches"] = n
        if n < 1:
            fail(f"{tag}: the main path never launched {name}")
    for b, (audio, spectra) in enumerate(outs):
        if audio.shape != (C, 2, T // 50) or spectra.shape != (
                T // spec.reshaper.interval, FFT):
            fail(f"step {b}: shapes {tuple(audio.shape)}, "
                 f"{tuple(spectra.shape)}")
        if not (torch.isfinite(audio).all() and torch.isfinite(spectra).all()):
            fail(f"step {b}: non-finite output")
    a16 = outs[1][0].double().cpu().numpy()
    a32 = ref32[1][0].double().cpu().numpy()
    d_snr = 10 * np.log10(np.mean(a32 ** 2) / max(np.mean((a16 - a32) ** 2),
                                                   1e-300))
    print(f"bf16 vs float32 audio (step 2): {d_snr:.1f} dB (bound 45)")
    if d_snr <= 45.0:
        fail("bf16 handoff audio too far from the float32 run")
    for b in (1, 2):
        # channels the retune moved off their carrier carry no oracle
        on = [ch for ch in range(C) if b < 2 or RETUNE[ch] == OFFSETS[ch]]
        aud = outs[b][0].double().cpu().numpy()[on]
        L, R = aud[:, 0], aud[:, 1]
        sep = 10 * np.log10(np.mean(L ** 2) / max(np.mean(R ** 2), 1e-300))
        n = L.shape[-1]
        tt = np.arange(n) / 48_000.0
        A = np.stack([np.cos(2 * np.pi * TONE_HZ * tt),
                      np.sin(2 * np.pi * TONE_HZ * tt), np.ones(n)], 1)
        snrs = []
        for ch in range(len(on)):
            coef, *_ = np.linalg.lstsq(A, L[ch], rcond=None)
            r = L[ch] - A @ coef
            snrs.append(10 * np.log10(np.mean((A[:, :2] @ coef[:2]) ** 2)
                                      / np.mean(r ** 2)))
        print(f"step {b}: tone SNR {np.mean(snrs):.1f} dB (bound 35), "
              f"L/R separation {sep:.1f} dB (bound 25)")
        if np.mean(snrs) <= 35.0 or sep <= 25.0:
            fail(f"step {b}: audio oracle failed")
        sp = outs[b][1][0].cpu().numpy()
        floor = np.percentile(sp, 2)
        for o in OFFSETS:
            k = int((o / FS + 0.5) * FFT)
            w = int(75e3 / FS * FFT)
            if sp[max(k - w, 0):k + w].max() < floor + 30.0:
                fail(f"step {b}: no spectrum peak at carrier {o:.0f} Hz")
        kmax = int(np.argmax(sp))
        fmax = (kmax / FFT - 0.5) * FS
        if np.min(np.abs(OFFSETS - fmax)) > 100e3:
            fail(f"step {b}: spectrum peak at {fmax:.0f} Hz, off the carriers")
    print("main path: launches "
          + ", ".join(f"{t}={report[t]['launches']}" for t in report))

    # ---- 5. step rate on bench-style noise input --------------------------
    precision.set_handoff_dtype("bf16")
    rng = np.random.default_rng(0)
    xn = tuple(torch.from_numpy((rng.standard_normal(T) * 0.1)
                                .astype(np.float32)).to(dev)
               for _ in range(2))
    params = radio.make_params_shared(OFFSETS)
    st = radio.init_state_shared(C)
    for _ in range(3):
        (audio, spectra), st = radio.apply_shared(params, st, xn,
                                                  spectrum=spec)
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        (audio, spectra), st = radio.apply_shared(params, st, xn,
                                                  spectrum=spec)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    print(f"WFM step (T={T}, C={C}, fft {FFT}, bf16 handoff): "
          f"{step_s * 1e3:.3f} ms, {T / step_s / 1e6:.1f} MS/s wideband "
          f"[{card}]")

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: report[t][k] for k in keys}
                                  for t in ("K1", "K2", "K3", "K4")]}))


if __name__ == "__main__":
    sys.exit(main())
