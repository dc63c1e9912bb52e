"""Kernels K14 (LogMMSE's frame recursions, csrc/logmmse.cu) and K15 (the
first-order linear recurrence, csrc/recurrence.cu) on the CPU: a numpy
model of each kernel's arithmetic, in its order, against the plain
version the CPU runs.  The kernels themselves run only on the card
(tests/test_torch_cuda.py holds them against the same plain versions).

K14's model is the kernel's per-bin loop vectorised over bins: every
operation rounds on its own, so the rings, sums, counters and the
has_prev flag equal the plain version's bit for bit, and the gains
(expf, logf and powf against torch's) agree to >= 120 dB.  On the card
K14 hands the rings over to the state it returns (``hand_over``); the
hand-over's marks are held here on CPU tensors, and ``LogMMSE.prime``
goes through ``logmmse_frames`` with the plain ``_push_history``'s
history bit for bit.

K15's model is its cluster-batched scan (a cluster of up to 16 blocks a
row, 32 segments a block, batches of 32 lanes × 4 samples, the lanes',
the segments' and the blocks' maps composed, each segment walked from
its start, every a·y + b one fused multiply-add).  On the paths' poles
and inputs (the front end's DC blocker at 50/SR over a 120 000-sample
block, the noise blanker's envelope, the AM demod's DC blocker on C = 4
rows) it is at least as close to the float64 recurrence as the plain
doubling scan, and agrees with the plain version to >= 80 dB (at the
slow pole both are ~79 dB from the float64 recurrence: the pole's powers
rounded in float32 products; they agree to ~138 dB).  Its fused DC
blocker and noise blanker forms, modelled the same way, agree with
``DCBlocker.apply`` and ``NoiseBlanker.apply`` to >= 100 and 130 dB."""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
from sdrplusplusbrown_tpu_torch.ops import recurrence as prec

from torch_parity import (dc_blocker_model, logmmse_frames_inputs,
                          noise_blanker_model, recurrence_cases,
                          recurrence_fused_cases,
                          recurrence_chunks_model, recurrence_cluster_size,
                          recurrence_segments, snr_db)


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
    # (at the front end's slow pole 78.71 dB from the float64 recurrence
    # against 78.70), and the two agree to 80 dB or better (137.7 there)
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


@pytest.mark.parametrize("T", [1, 100, 128, 2_400, 4_097, 65_536, 120_000,
                               480_000])
def test_k15_segments_cover_each_sample_once(T):
    """K15's partition at ``recurrence_cluster_size(T)`` and at smaller
    clusters: every sample of the row in exactly one lane's slot, in order
    along each warp's segment and from one segment and block to the next.
    At its own size no block of the cluster is idle, and below 16 blocks
    each warp takes one batch."""
    C0 = recurrence_cluster_size(T)
    for C in sorted({C0, 1, 3, 8}):
        idx = recurrence_segments(T, C)
        flat = idx.reshape(-1)
        flat = flat[flat >= 0]
        np.testing.assert_array_equal(flat, np.arange(T))
    idx = recurrence_segments(T, C0)
    assert (idx.reshape(C0, -1) >= 0).any(-1).all()
    assert C0 == 16 or idx.shape[2] == 1


@pytest.mark.parametrize("case", list(recurrence_fused_cases()),
                         ids=lambda c: c[0])
def test_k15_fused_models_match_the_blocks(case):
    """K15's "dc" and "nb" forms (the recurrence as the kernel groups it,
    the blocks' elementwise ops as torch rounds them) against
    ``DCBlocker.apply`` and ``NoiseBlanker.apply`` on the CPU, which run
    the plain route (the doubling scan, then torch ops): out and the new
    state >= 100 dB (DC) and 130 dB (NB)."""
    name, form, pole, gain, level, x, y0 = case
    tx, ty0 = torch.from_numpy(x), torch.from_numpy(y0)
    if form == "dc":
        want = prec.DCBlocker(gain).apply(None, ty0, tx)
        got = dc_blocker_model(pole, gain, x, y0)
        bar = 100.0
    else:
        blk = prec.NoiseBlanker(gain, level)
        want = blk.apply({"level": torch.tensor(level)} if level != 10.0
                         else None, ty0, tx)
        got = noise_blanker_model(pole, gain, level, x, y0)
        bar = 130.0
        assert (want[0].numpy() != x).any(), "no sample blanked"
    assert want[0].shape == x.shape and want[1].shape == y0.shape
    assert snr_db(want[0].numpy(), got[0]) >= bar, name
    assert snr_db(want[1].numpy(), got[1]) >= bar, name


def test_k15_forms_run_the_plain_route_on_the_cpu():
    """``linear_recurrence``'s "dc" and "nb" forms on CPU tensors are
    ``dc_route`` and ``nb_route`` around the doubling scan, bit for bit,
    and launch nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((2, 700)) + 1j
                          * rng.standard_normal((2, 700)))
                         .astype(np.complex64))
    dc0, nb0 = torch.zeros(2, dtype=torch.complex64), torch.ones(2)
    n0 = prec.linear_recurrence_kernel.launches
    got = prec.linear_recurrence(0.99, x, dc0, "dc", 0.01)
    want = prec.dc_route(prec.linear_recurrence_ref, 0.99, x, dc0, 0.01)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = prec.linear_recurrence(0.98, x, nb0, "nb", 0.02, 1.5)
    want = prec.nb_route(prec.linear_recurrence_ref, 0.98, x, nb0, 0.02,
                         1.5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert prec.linear_recurrence_kernel.launches == n0


# ---- K14's hand-over and LogMMSE's priming --------------------------------

def test_k14_hand_over_marks_the_given_state():
    """``hand_over`` gives the rings to a new state (the same storage and
    values) and empties and marks the given state's, so a second use of
    it raises in ``check_rings``, ``LogMMSE.apply`` and the kernel's
    wrapper, naming the hand-over."""
    core = plm.LogMMSE(96_000.0, wideband=True)
    st, sig = logmmse_frames_inputs(core, (), 5, 12, seed=4)
    rings = {k: st[k].clone() for k in plm.RINGS}
    ptrs = {k: st[k].data_ptr() for k in plm.RINGS}
    new = plm.hand_over(st)
    for k in plm.RINGS:
        assert torch.equal(new[k], rings[k]) and new[k].data_ptr() == ptrs[k]
        assert st[k].numel() == 0 and st[k].handed_over
    plm.check_rings({**st, **new})
    with pytest.raises(RuntimeError, match="handed over"):
        plm.check_rings(st)
    x = torch.zeros(4 * core.len2, dtype=torch.complex64)
    with pytest.raises(RuntimeError, match="handed over"):
        core.apply(None, st, x)
    with pytest.raises(RuntimeError, match="handed over"):
        plm.logmmse_frames_kernel(core, st, sig, None)


@pytest.mark.parametrize("wideband", [True, False])
def test_prime_goes_through_logmmse_frames(monkeypatch, wideband):
    """``LogMMSE.prime`` pushes its 12 noise frames through
    ``logmmse_frames`` (on the card K14, one launch) and keeps its history
    half: the ring, sums and counters are the plain ``_push_history``'s
    bit for bit, Xk_prev and has_prev the given state's."""
    core = plm.LogMMSE(96_000.0 if wideband else 24_000.0,
                       wideband=wideband)
    batch = () if wideband else (2,)
    st, _ = logmmse_frames_inputs(core, batch, 1, 7, seed=9)
    rng = np.random.default_rng(11)
    n = core.NOISE_FRAMES * core.Slen
    x0 = torch.from_numpy((rng.standard_normal(batch + (n,)) + 1j
                           * rng.standard_normal(batch + (n,)))
                          .astype(np.complex64))
    calls = []
    orig = plm.logmmse_frames

    def spy(c, s, sig, hold):
        calls.append(sig.shape)
        return orig(c, s, sig, hold)
    monkeypatch.setattr(plm, "logmmse_frames", spy)
    before = {k: v.clone() for k, v in st.items()}
    got = core.prime(st, x0)
    assert calls == [batch + (core.NOISE_FRAMES, core.nFFT)]
    _, sig = core._spectra(x0.reshape(batch + (core.NOISE_FRAMES,
                                               core.Slen)))
    want = core._push_history(dict(before), sig, None)
    for k in ("hist", "dev_hist", "sums", "devs", "count", "pos"):
        assert torch.equal(got[k], want[k]), k
    for k in ("Xk_prev", "has_prev"):
        assert torch.equal(got[k], before[k]), k
    assert bool(got["primed"].all())
