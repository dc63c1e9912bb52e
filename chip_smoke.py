#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths through their seven hand-written CUDA
kernels, which it first builds from ``sdrplusplusbrown_tpu_torch/csrc``:

  * broadcast FM — ``Radio.apply_shared`` on the WFM-8 configuration (one
    2.4 MS/s wideband, 8 stereo WFM VFOs, a 65 536-bin spectrum at 20 fps,
    240 000-sample steps): K1 front end, K2 WFM demod, K3 audio polyphase,
    K4 spectrum;
  * the wide-bank NFM scanner — ``Radio.apply_channelized`` on the
    scanner128 configuration (bench.py:build_scanner: 128 squelched NFM
    channels at linspace(−1.1, 1.1) MHz + 917 Hz on the same wideband),
    and one step of scanner256: K5 PFB, K6 post-channelizer, K7 demod +
    audio.

Phases, each fatal on failure:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build and its time;
  3. K1-K4 each against its plain PyTorch version on the same inputs, at
     the WFM path's shapes on a stereo FM signal, float32 handoff; both
     timed with CUDA events;
  4. three WFM steps with a retune before the third, in the production
     bf16 handoff, the launch counts zeroed just before: every kernel
     launched, finite outputs, the audio oracles (tone SNR, stereo
     separation), spectrum peaks on the carriers, and bf16 audio within
     45 dB of the float32 run;
  5. the WFM-8 step on bench-style noise input: its rate, its wall time
     and a profiler window (see ``step_rate``);
  6. K5-K7 each against its plain version at the scanner128 shapes on an
     NFM signal (a 1 kHz tone on every 8th channel), float32 handoff,
     timed with CUDA events;
  7. three scanner128 steps with a retune before the third, bf16 handoff,
     the counts zeroed just before: K5, K6 and K7 once each per step,
     exactly the tone channels open, their tone SNR;
  8. one scanner256 step: K5-K7 one launch each, each against its plain
     version;
  9. the scanner128 step (bf16, raw audio) on the same noise, as in 5.

Each kernel's bound is the larger of the bytes its function must move
over 3.35 TB/s and its float32 operations over 67 TFLOP/s (the H100 SXM's
published HBM and non-tensor FP32 rates).  The next-to-last line is a
JSON report of the kernels; the last line, printed only when every phase
passed, is the device JSON.  Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
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

SCAN_C = 128
SCAN_WIDE_C = 256
SCAN_OFFSETS = np.linspace(-1.1e6, 1.1e6, SCAN_C) + 917.0
SCAN_TONES = list(range(0, SCAN_C, 8))
# the retune moves the channels half-way between tone channels by 3 kHz
SCAN_RETUNE = SCAN_OFFSETS + np.where(np.arange(SCAN_C) % 8 == 4, 3e3, 0.0)
SQUELCH_DB = -30.0

HBM_BPS = 3.35e12            # H100 SXM HBM3, bytes/s
FP32_FLOPS = 67e12           # H100 SXM non-tensor FP32, flop/s


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


def nfm_wideband(n: int, offsets, tone_channels) -> np.ndarray:
    """An NFM carrier (1 kHz tone, 2 kHz peak deviation) on each tone
    channel's offset, plus low noise."""
    t = np.arange(n) / FS
    phase = 2 * np.pi * 2000.0 * np.cumsum(np.sin(2 * np.pi * TONE_HZ * t)) / FS
    rng = np.random.default_rng(11)
    x = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for k in tone_channels:
        x = x + 0.3 * np.exp(1j * (2 * np.pi * offsets[k] * t + phase))
    return x.astype(np.complex64)


def tone_snr_db(audio) -> float:
    """SNR of the 1 kHz tone in a 48 kHz audio row (sine fit)."""
    n = audio.shape[-1]
    tt = np.arange(n) / 48_000.0
    A = np.stack([np.cos(2 * np.pi * TONE_HZ * tt),
                  np.sin(2 * np.pi * TONE_HZ * tt), np.ones(n)], 1)
    coef, *_ = np.linalg.lstsq(A, audio, rcond=None)
    r = audio - A @ coef
    return float(10 * np.log10(np.mean((A[:, :2] @ coef[:2]) ** 2)
                               / np.mean(r ** 2)))


def snr_db(ref, got) -> float:
    ref = ref.double()
    err = got.double() - ref
    return float(10 * np.log10(float((ref ** 2).mean())
                               / max(float((err ** 2).mean()), 1e-300)))


def nbytes(dtype) -> int:
    import torch
    return torch.empty((), dtype=dtype).element_size()


def work(tag: str, args) -> tuple:
    """(bytes, float32 operations) that kernel ``tag``'s function needs
    on these arguments: each input read once, each output written once,
    the valid outputs' direct-form multiply-adds (2 operations each) and
    the elementwise arithmetic.  Transcendentals (sin/cos, the minimax
    atan2's 20-odd operations aside) are not counted."""
    if tag == "K1":
        pipe, xr, xi, tail, omega, base, tails, odt = args
        T, Cn = xr.shape[0], omega.shape[0]
        m = pipe.lengths(T)
        b = 8 * T + 2 * Cn * m[-1] * nbytes(odt)
        ops = 2 * 2 * Cn * m[0] * pipe.K0 + 6 * Cn * T
        for s, st in enumerate(pipe.stages):
            ops += 2 * 2 * Cn * m[s + 1] * st["kernel"].shape[1]
        return b, ops
    if tag == "K2":
        pipe, iq, m_if, qprev, hb_tails, hist, odt = args
        Cn = iq.shape[0] // 2
        b = 2 * Cn * m_if * iq.element_size()
        ops, m = 6 * Cn * m_if, m_if
        for h in pipe.hb_taps:
            m //= 2
            ops += 2 * Cn * m * len(h)
        b += 2 * Cn * m * nbytes(odt)
        return b, ops + Cn * m * (4 * pipe.K + 12)
    if tag == "K3":
        pipe, raw, m_in, ptail, _ = args
        m_aud = m_in // pipe.D * pipe.I
        return (raw.shape[0] * (m_in * raw.element_size() + 4 * m_aud),
                2 * raw.shape[0] * m_aud * pipe.kernel.shape[1])
    if tag == "K4":
        xr, xi, keep, interval, N, floor_db, window = args
        n = xr.shape[0] // interval
        return (n * (8 * keep + 4 * N),
                n * (5 * N * int(np.log2(N)) + 2 * keep + 4 * N))
    if tag == "K5":     # the M-point DFT counted as an FFT, as K4's is
        pipe, xr, xi, xwr, xwi, width, tdt, odt = args
        Tb = 2 * xr.shape[0] // pipe.M
        return (8 * xr.shape[0] + 2 * pipe.M * width * nbytes(odt),
                Tb * (2 * 2 * pipe.K0 + 5 * pipe.M * np.log2(pipe.M)))
    if tag == "K6":
        pipe, bins, bin_idx, om, ph0, span, sbs, tails, Tb, odt, tdt = args
        Cn = om.shape[0]
        plan = pipe.plan(Tb)
        rows = min(Cn, pipe.M)
        m1, m_out = plan["m"][1], plan["m"][-1]
        return (2 * rows * Tb * bins.element_size()
                + 2 * Cn * plan["n_out"] * nbytes(odt),
                Cn * (6 * Tb + 2 * 2 * m1 * len(pipe.taps[0])
                      + 2 * 2 * m_out * len(pipe.taps[1]) + 4 * m_out))
    if tag == "K7":
        pipe, iq, m_if, gate, qprev, ftail, ptail, odt, tdt = args
        Cn = iq.shape[0] // 2
        plan = pipe.plan(m_if)
        return (2 * Cn * m_if * iq.element_size()
                + Cn * plan["n_aud"] * nbytes(odt),
                Cn * (30 * m_if + 2 * m_if * len(pipe.hf)
                      + 2 * plan["m_aud"] * pipe.kernel.shape[1]))
    raise KeyError(tag)


def bound(tag: str, args) -> tuple:
    """(bound_ms, bound_by) of kernel ``tag`` on these arguments."""
    b, ops = work(tag, args)
    tb, to = b / HBM_BPS * 1e3, ops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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


def noise_planes(T: int, dev):
    """Bench-style input: (re, im) planes of N(0, 0.1²) noise."""
    import torch
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy((rng.standard_normal(T) * 0.1)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def short_kernel(key: str) -> str:
    """A profiler kernel name without namespaces, template arguments or
    parameter list."""
    k = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[(<]", k, maxsplit=1)[0].split("::")[-1].strip()


def step_rate(label: str, step, st, T: int, card: str) -> None:
    """Times ``step`` (state → state') on one T-sample block: the mean of
    100 pipelined steps (the throughput), the wall-time percentiles of 200
    steps each followed by a sync (the latency), and a torch.profiler
    window of 20 synced steps.  From the window: device time per step by
    kernel, the kernel launches and host-to-device copies per step, and
    the device's idle share, 1 − (the window's kernel and copy time) /
    (its wall time); one stream, so those never overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        st = step(st)
    torch.cuda.synchronize()
    walls = []
    for _ in range(200):
        t0 = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(100):
        st = step(st)
    torch.cuda.synchronize()
    pipe_s = (time.perf_counter() - t0) / 100
    pct = " / ".join(f"{np.percentile(walls, q):.4f}" for q in (50, 10, 90, 99))
    print(f"{label} step (T={T}, bf16 handoff): pipelined "
          f"{pipe_s * 1e3:.4f} ms, {T / pipe_s / 1e6:.1f} MS/s wideband; "
          f"synced median / p10 / p90 / p99 {pct} ms [{card}]")
    n = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st = step(st)
            torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_kernel, launches, h2d = {}, 0, 0
    for evt in prof.key_averages():
        if evt.key == "cudaLaunchKernel":
            launches += evt.count
        if "Memcpy HtoD" in evt.key:
            h2d += evt.count
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        # device-side entries: kernels and copies, not the CPU ops and
        # runtime calls that launched them
        if us > 0 and not evt.key.startswith(("aten::", "cuda")):
            k = short_kernel(evt.key)
            by_kernel[k] = by_kernel.get(k, 0.0) + us / n
    busy = sum(by_kernel.values())
    if busy <= 0:
        print(f"{label} profile: device time not measured (the profiler "
              f"saw no device activity); {launches / n:.1f} launches and "
              f"{h2d / n:.1f} host-to-device copies per step")
        return
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} profile ({n} synced steps): device {busy:.1f} us/step, "
          f"idle share {1.0 - busy * n / window_us:.3f}, "
          f"{launches / n:.1f} kernel launches and {h2d / n:.1f} "
          f"host-to-device copies per step; us/step by kernel: "
          + ", ".join(f"{k} {v:.1f}" for k, v in top) + f" [{card}]")


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
    dev = torch.device("cuda", 0)
    report = drive(dev, card)
    report.update(drive_scanner(dev, card))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: report[t][k] for k in keys}
                                  for t in sorted(report)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive(dev, card: str) -> dict:
    """Phases 2-5 on ``dev``; raises on the first failure.  Returns the
    K1-K4 entries of the kernel report."""
    import torch
    from sdrplusplusbrown_tpu_torch.kernels import _build
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import fft_kernel as k4
    from sdrplusplusbrown_tpu_torch.ops import precision
    from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())

    radio = Radio(FS, DEMOD_WFM, device=dev)
    spec = SpectrumPath(FS, fft_size=FFT, fft_rate=20.0, device=dev)
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref32, captured = capture(("K1", "K2", "K3", "K4"),
                              lambda: run3("float32"))
    report = {}
    for tag in ("K1", "K2", "K3", "K4"):
        args = captured[tag]
        mod, name = kernel_fn(tag, "")
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
            min_db = 80.0 if tag == "K1" else 70.0
            agree = f"{s:.1f} dB SNR (bound {min_db:.0f})"
            ok = s >= min_db
        ms = event_ms(lambda: kern(*args))
        plain_ms = event_ms(lambda: ref(*args))
        library_ms = None
        if tag == "K3":          # one strided correlation: one conv1d call
            pipe, raw, m_in = args[0], args[1], args[2]
            ext = torch.cat([args[3], raw[:, :m_in].float()], dim=1)[:, None]
            ker = pipe.taps(dev, args[4])[:, None, :]
            library_ms = event_ms(lambda: torch.nn.functional.conv1d(
                ext, ker, stride=pipe.D))
        if tag == "K4":          # the FFT of the windowed frames
            xr, xi, keep, interval = args[0], args[1], args[2], args[3]
            starts = k4.frame_starts(xr.shape[0], keep, interval)
            fr = torch.stack([torch.complex(xr[p:p + keep], xi[p:p + keep])
                              for p in starts]) * args[6]
            library_ms = event_ms(lambda: torch.fft.fft(fr, n=FFT, dim=-1))
        bms, by = bound(tag, args)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{tag} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {bms:.4f} ms ({by}), "
              f"max|err| {err:.3e}, {agree} [{card}]")
        if not ok:
            fail(f"{tag}: kernel disagrees with its plain version: {agree}")
        report[tag] = {"name": name, "route": "cuda",
                       "source": KERNELS[tag][2], "replaces": KERNELS[tag][3],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": library_ms}

    # ---- 4. the main path, production bf16 handoff ------------------------
    reset_counts()
    outs = run3("bf16")
    for tag in ("K1", "K2", "K3", "K4"):
        mod, name = kernel_fn(tag, "_kernel")
        n = getattr(mod, name).launches
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

    # ---- 5. the WFM-8 step on bench-style noise input --------------------
    precision.set_handoff_dtype("bf16")
    xn = noise_planes(T, dev)
    params = radio.make_params_shared(OFFSETS)
    step_rate(f"WFM-8 (C={C}, fft {FFT})",
              lambda st: radio.apply_shared(params, st, xn, spectrum=spec)[1],
              radio.init_state_shared(C), T, card)
    return report


KERNELS = {
    "K1": ("mono_frontend", "mono_frontend",
           "sdrplusplusbrown_tpu_torch/csrc/mono_frontend.cu",
           "sdrplusplusbrown_tpu/ops/mono_frontend.py:123"),
    "K2": ("wfm_kernel", "wfm_demod",
           "sdrplusplusbrown_tpu_torch/csrc/wfm_demod.cu",
           "sdrplusplusbrown_tpu/ops/wfm_kernel.py:47"),
    "K3": ("wfm_kernel", "mpx_audio_poly",
           "sdrplusplusbrown_tpu_torch/csrc/mpx_poly.cu",
           "sdrplusplusbrown_tpu/ops/wfm_kernel.py:418"),
    "K4": ("fft_kernel", "spectrum_frames_db",
           "sdrplusplusbrown_tpu_torch/csrc/spectrum_fft.cu",
           "sdrplusplusbrown_tpu/ops/pallas_fft.py:253"),
    "K5": ("channelizer_kernel", "pfb_bins",
           "sdrplusplusbrown_tpu_torch/csrc/pfb_channelizer.cu",
           "sdrplusplusbrown_tpu/ops/pallas_channelizer.py:856"),
    "K6": ("chan_frontend", "chan_post",
           "sdrplusplusbrown_tpu_torch/csrc/chan_post.cu",
           "sdrplusplusbrown_tpu/ops/chan_frontend.py:77"),
    "K7": ("demod_kernel", "fm_audio",
           "sdrplusplusbrown_tpu_torch/csrc/fm_audio.cu",
           "sdrplusplusbrown_tpu/ops/demod_kernel.py:80"),
}


def kernel_fn(tag: str, suffix: str):
    import importlib
    mod = importlib.import_module("sdrplusplusbrown_tpu_torch.ops."
                                  + KERNELS[tag][0])
    return mod, KERNELS[tag][1] + suffix


def reset_counts() -> None:
    """Every kernel's launch count to 0 (just before a main-path run)."""
    for tag in KERNELS:
        mod, name = kernel_fn(tag, "_kernel")
        getattr(mod, name).launches = 0


def capture(tags, run):
    """Run ``run()`` with the wrappers of ``tags`` recording their last
    arguments; returns (run's result, {tag: args})."""
    captured, originals = {}, {}
    for tag in tags:
        mod, name = kernel_fn(tag, "_kernel")
        originals[tag] = orig = getattr(mod, name)

        def rec(*args, _tag=tag, _orig=orig):
            captured[_tag] = args
            return _orig(*args)
        setattr(mod, name, rec)
    try:
        out = run()
    finally:
        for tag in tags:
            mod, name = kernel_fn(tag, "_kernel")
            setattr(mod, name, originals[tag])
    return out, captured


def check_scanner_kernel(tag: str, args, card: str, bound_db: float,
                         timed: bool) -> dict:
    """K5-K7 against its plain version on ``args``; with ``timed`` both
    are timed with CUDA events.  Raises on disagreement."""
    import torch
    mod, name = kernel_fn(tag, "")
    kern = getattr(mod, name + "_kernel")
    ref = getattr(mod, name + "_ref")
    got, want = kern(*args), ref(*args)
    torch.cuda.synchronize()
    if tag == "K6":       # (IF, sums, tails): the valid IF and the sums
        m = args[0].plan(args[8])["m"][-1]
        got, want = (got[0][:, :m], got[1]), (want[0][:, :m], want[1])
    else:
        got, want = got if isinstance(got, tuple) else (got,), \
            want if isinstance(want, tuple) else (want,)
    g, w = got[0].float(), want[0].float()
    if not torch.isfinite(g).all():
        fail(f"{tag}: non-finite kernel output")
    err = float((g - w).abs().max())
    s = snr_db(w, g)
    agree = f"{s:.1f} dB SNR (bound {bound_db:.0f})"
    if tag == "K6":
        rel = float(((got[1] - want[1]).abs() / want[1].abs()).max())
        agree += f", squelch sums rel err {rel:.1e} (bound 1e-5)"
        if rel > 1e-5:
            fail(f"K6: squelch sums disagree: {rel}")
    out = {"name": name, "route": "cuda", "source": KERNELS[tag][2],
           "replaces": KERNELS[tag][3], "max_abs_err": err}
    if timed:
        out["ms"] = event_ms(lambda: kern(*args))
        out["plain_ms"] = event_ms(lambda: ref(*args))
        out["bound_ms"], out["bound_by"] = bound(tag, args)
        out["library_ms"] = None
        print(f"{tag} {name}: kernel {out['ms']:.4f} ms, plain "
              f"{out['plain_ms']:.4f} ms, library n/a, bound "
              f"{out['bound_ms']:.4f} ms ({out['bound_by']}), max|err| "
              f"{err:.3e}, {agree} [{card}]")
    else:
        print(f"{tag} {name} at C = {SCAN_WIDE_C}: max|err| {err:.3e}, "
              f"{agree}")
    if s < bound_db:
        fail(f"{tag}: kernel disagrees with its plain version: {agree}")
    return out


def drive_scanner(dev, card: str) -> dict:
    """Phases 6-9 on ``dev``; raises on the first failure.  Returns the
    K5-K7 entries of the kernel report."""
    import torch
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_NFM
    from sdrplusplusbrown_tpu_torch.ops import precision

    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True, device=dev)
    g = radio.in_multiple
    T = (STEP + g - 1) // g * g
    x = nfm_wideband(3 * T, SCAN_OFFSETS, SCAN_TONES)
    blocks = [(torch.from_numpy(x[b * T:(b + 1) * T].real.copy()).to(dev),
               torch.from_numpy(x[b * T:(b + 1) * T].imag.copy()).to(dev))
              for b in range(3)]

    def run3(handoff: str, C: int = SCAN_C, n: int = 3):
        precision.set_handoff_dtype(handoff)
        st = radio.init_state_channelized(C)
        outs = []
        for b in range(n):
            offs = (SCAN_OFFSETS if b < 2 else SCAN_RETUNE)[:C] if C == \
                SCAN_C else np.linspace(-1.1e6, 1.1e6, C) + 917.0
            params = radio.make_params_channelized(offs,
                                                   squelch_level=SQUELCH_DB)
            audio, st = radio.apply_channelized(params, st, blocks[b],
                                                mono_out=True)
            outs.append(audio)
        torch.cuda.synchronize()
        return outs

    # ---- 6. K5-K7 against their plain versions, scanner128 ---------------
    tags = ("K5", "K6", "K7")
    _, captured = capture(tags, lambda: run3("float32"))
    report = {}
    for tag in tags:
        report[tag] = check_scanner_kernel(tag, captured[tag], card,
                                           100.0 if tag == "K5" else 80.0,
                                           timed=True)

    # ---- 7. the scanner main path, production bf16 handoff ---------------
    reset_counts()
    outs = run3("bf16")
    for tag in tags:
        mod, name = kernel_fn(tag, "_kernel")
        n = getattr(mod, name).launches
        report[tag]["launches"] = n
        if n != 3:
            fail(f"{tag}: {n} launches in 3 scanner steps, expected 3")
    for b, audio in enumerate(outs):
        if audio.shape != (SCAN_C, T // 50) or not torch.isfinite(audio).all():
            fail(f"scanner step {b}: shape {tuple(audio.shape)} or "
                 f"non-finite audio")
        opened = (audio.abs().amax(-1) > 0).nonzero().flatten().tolist()
        if opened != SCAN_TONES:
            fail(f"scanner step {b}: open channels {opened}, expected "
                 f"{SCAN_TONES}")
        if b:
            a = audio.double().cpu().numpy()
            snrs = [tone_snr_db(a[ch]) for ch in SCAN_TONES]
            print(f"scanner step {b}: {len(opened)} of {SCAN_C} channels "
                  f"open (the tone channels), tone SNR min "
                  f"{min(snrs):.1f} dB, mean {np.mean(snrs):.1f} dB "
                  f"(bound 40)")
            if min(snrs) < 40.0:
                fail(f"scanner step {b}: tone SNR {min(snrs):.1f} dB")
    print("scanner path: launches "
          + ", ".join(f"{t}={report[t]['launches']}" for t in tags))

    # ---- 8. scanner256: one step, one launch each ------------------------
    reset_counts()
    _, cap256 = capture(tags, lambda: run3("bf16", C=SCAN_WIDE_C, n=1))
    for tag in tags:
        mod, name = kernel_fn(tag, "_kernel")
        if getattr(mod, name).launches != 1:
            fail(f"{tag}: {getattr(mod, name).launches} launches in one "
                 f"scanner256 step")
        # bf16 storage: a float32 difference that crosses a bf16 rounding
        # boundary moves a value by a bf16 ulp (2^-8)
        check_scanner_kernel(tag, cap256[tag], card,
                             60.0 if tag == "K5" else 45.0, timed=False)

    # ---- 9. the scanner128 step (bench.py's: raw mono audio) -------------
    precision.set_handoff_dtype("bf16")
    xn = noise_planes(T, dev)
    params = radio.make_params_channelized(SCAN_OFFSETS,
                                           squelch_level=SQUELCH_DB)
    step_rate(f"scanner128 (C={SCAN_C}, raw audio)",
              lambda st: radio.apply_channelized(params, st, xn, mono_out=True,
                                                 raw_audio=True)[1],
              radio.init_state_channelized(SCAN_C), T, card)
    return report


if __name__ == "__main__":
    sys.exit(main())
