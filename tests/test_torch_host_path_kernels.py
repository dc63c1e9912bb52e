"""Kernels K14 (LogMMSE's frame recursions, csrc/logmmse.cu) and K15 (the
first-order linear recurrence, csrc/recurrence.cu) on the CPU: a numpy
model of each kernel's arithmetic, in its order, against the plain
version the CPU runs.  The kernels themselves run only on the card
(tests/test_torch_cuda.py holds them against the same plain versions).

K14's model is the kernel's per-bin loop vectorised over bins: every
operation rounds on its own, so the rings, sums, counters and the
has_prev flag equal the plain version's bit for bit, and the gains
(expf, logf and powf against torch's) agree to >= 120 dB.  K15's model is
its warp-batched scan (32 segments a row, batches of 32 lanes × 4
samples, the lanes' maps scanned, the segments' maps scanned, each
segment walked from its start).  On the paths' poles
and inputs (the front end's DC blocker at 50/SR over a 120 000-sample
block, the noise blanker's envelope, the AM demod's DC blocker on C = 4
rows) it is at least as close to the float64 recurrence as the plain
doubling scan, and agrees with the plain version to >= 80 dB (at the
slow pole both are ~79 dB from the float64 recurrence: the pole's powers
rounded in float32 products; they agree to ~109 dB)."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
from sdrplusplusbrown_tpu_torch.ops import recurrence as prec

from torch_parity import (logmmse_frames_inputs, recurrence_cases,
                          recurrence_chunks_model, snr_db)


# ---- K14 -------------------------------------------------------------------

def _e1_model(x):
    f = np.float32
    a, p, q = plm._E1_A, plm._E1_P, plm._E1_Q
    x = np.maximum(x, f(1e-8))
    xs = np.minimum(x, f(1.0))
    poly = a[1] + xs * (a[2] + xs * (a[3] + xs * (a[4] + xs * a[5])))
    small = (-np.log(xs) + a[0]) + xs * poly
    xl = np.maximum(x, f(1.0))
    x2, x3, x4 = xl * xl, xl * xl * xl, xl ** f(4)
    num = x4 + x3 * p[0] + x2 * p[1] + xl * p[2] + p[3]
    den = x4 + x3 * q[0] + x2 * q[1] + xl * q[2] + q[3]
    large = (np.exp(-xl) / xl) * (num / den)
    return np.where(x <= f(1.0), small, large).astype(np.float32)


def _k14_model(core, st, sig, hold):
    """csrc/logmmse.cu's loop over frames, every bin at once (numpy
    float32, one rounding an operation)."""
    f = np.float32
    g = {k: v.numpy().copy() for k, v in st.items()}
    sig = sig.numpy()
    H = core.H
    aa, one_m_aa = f(core.aa), f(1.0) - f(core.aa)
    ksi_min = f(core.ksi_min)
    count, pos = int(g["count"]), int(g["pos"])
    held = hold is not None and bool(hold)
    sums, devs, xk, hp = g["sums"], g["devs"], g["Xk_prev"], g["has_prev"]
    m2 = np.maximum(g["noise_mu2"], f(1e-30))
    hws = []
    for fr in range(sig.shape[-2]):
        s = sig[..., fr, :]
        old = g["hist"][..., pos, :].copy()
        old_dev = g["dev_hist"][..., pos, :].copy()
        full = count >= H
        sums2 = (sums + s) - (old if full else f(0))
        count2 = count if full else count + 1
        d = s - sums2 / f(count2)
        diff = d * d
        devs2 = (devs + diff) - (old_dev if full else f(0))
        pos2 = (pos + 1) % H
        noise = s
        if held:
            noise, diff, sums2, devs2 = old, old_dev, sums, devs
            count2, pos2 = count, pos
        g["hist"][..., pos, :] = noise
        g["dev_hist"][..., pos, :] = diff
        sums, devs, count, pos = sums2, devs2, count2, pos2
        gammak = np.minimum((s * s) / m2, f(40))
        gm = np.maximum(gammak - f(1), f(0))
        ksi_first = gm * one_m_aa + aa
        ksi_dd = np.maximum((xk * aa) / m2 + gm * one_m_aa, ksi_min)
        ksi = np.where(hp[..., None], ksi_dd, ksi_first)
        A = ksi / (ksi + f(1))
        hw = A * np.exp(_e1_model(A * gammak) * f(0.5))
        sg = s * hw
        xk = sg * sg
        hp = np.ones_like(hp)
        hws.append(hw)
    g.update(sums=sums, devs=devs, Xk_prev=xk, has_prev=hp,
             count=np.int32(count), pos=np.int32(pos))
    return g, np.stack(hws, axis=-2)


@pytest.mark.parametrize("wideband,batch,frames,count,hold", [
    (True, (), 5, 7, None),        # the served IF NR, ring filling
    (True, (), 5, 230, None),      # the ring full (count >= H)
    (True, (), 5, 230, True),      # a held block
    (False, (2,), 4, 1999, None),  # the AF NR at batch 2, filling to full
    (False, (2,), 4, 40, False),
])
def test_k14_model_matches_the_plain_version(wideband, batch, frames,
                                             count, hold):
    # the IF NR's branch and H at 96 kS/s (fewer bins than at 2.4 MS/s),
    # the AF NR's at 24 kS/s
    core = plm.LogMMSE(96_000.0 if wideband else 24_000.0,
                       wideband=wideband)
    st, sig = logmmse_frames_inputs(core, batch, frames, count, seed=count)
    h = None if hold is None else torch.tensor(hold)
    before = {k: v.clone() for k, v in st.items()}
    got_st, got_hw = plm.logmmse_frames(core, st, sig, h)
    for k, v in st.items():      # the caller's state is not touched
        assert torch.equal(v, before[k]), k
    want_st, want_hw = _k14_model(core, st, sig, h)
    for k in ("hist", "dev_hist", "sums", "devs", "count", "pos",
              "has_prev"):
        np.testing.assert_array_equal(got_st[k].numpy(), want_st[k], k)
    for got, want in ((got_hw, want_hw), (got_st["Xk_prev"],
                                          want_st["Xk_prev"])):
        assert got.shape == want.shape
        assert snr_db(want, got.numpy()) >= 120.0


def test_k14_dispatch_runs_the_plain_version_on_the_cpu():
    core = plm.LogMMSE(96_000.0, wideband=True)
    st, sig = logmmse_frames_inputs(core, (), 5, 12, seed=3)
    n0 = plm.logmmse_frames_kernel.launches
    got_st, got_hw = plm.logmmse_frames(core, st, sig, None)
    want_st, want_hw = plm.logmmse_frames_ref(core, st, sig, None)
    assert plm.logmmse_frames_kernel.launches == n0
    assert torch.equal(got_hw, want_hw)
    for k, v in want_st.items():
        assert torch.equal(got_st[k], v), k


def test_k14_kernel_refuses_cpu_tensors():
    core = plm.LogMMSE(96_000.0, wideband=True)
    st, sig = logmmse_frames_inputs(core, (), 5, 12, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        plm.logmmse_frames_kernel(core, st, sig, None)


# ---- K15 -------------------------------------------------------------------

@pytest.mark.parametrize("case", list(recurrence_cases()), ids=lambda c: c[0])
def test_k15_model_matches_the_plain_version(case):
    _, a, b, y0 = case
    ta = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    plain = prec.linear_recurrence_ref(ta, torch.from_numpy(b),
                                       torch.from_numpy(y0)).numpy()
    got = recurrence_chunks_model(a, b, y0)
    wide = np.complex128 if np.iscomplexobj(b) else np.float64
    a64 = np.asarray(a, np.float32).astype(np.float64)
    truth = recurrence_chunks_model(a64, b.astype(wide), y0.astype(wide))
    # the kernel's grouping is no less accurate than the doubling scan's
    # (at the front end's slow pole 79.0 dB from the float64 recurrence
    # against 78.7), and the two agree to 80 dB or better (108.9 there)
    assert snr_db(truth, got) >= snr_db(truth, plain) - 0.5
    assert snr_db(plain, got) >= 80.0


def test_k15_dispatch_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal((2, 500)).astype(np.float32))
    y0 = torch.zeros(2)
    n0 = prec.linear_recurrence_kernel.launches
    got = prec.linear_recurrence(0.9, b, y0)
    assert prec.linear_recurrence_kernel.launches == n0
    assert torch.equal(got, prec.linear_recurrence_ref(0.9, b, y0))
    with pytest.raises(ValueError, match="CUDA"):
        prec.linear_recurrence_kernel(0.9, b, y0)
