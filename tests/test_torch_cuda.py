"""The port's CUDA kernels against their plain versions, on the card, over
shapes the main path does not reach (odd channel counts, partial tiles and
windows, both handoff dtypes, every supported FFT size, the scanner banks
at C = 8, 128 and 256 with offsets at both band edges; the TX path's K8,
K9 and K12 at its shapes).  These need an
NVIDIA GPU and skip without one; on the GPU machine, which has no JAX, run

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.radio import (
    Radio, DEMOD_AM, DEMOD_CW, DEMOD_DSB, DEMOD_NFM, DEMOD_USB, DEMOD_WFM)
from sdrplusplusbrown_tpu_torch.ops import (chan_frontend, channelizer_kernel,
                                            demod_kernel, fft_kernel,
                                            mono_frontend)
from sdrplusplusbrown_tpu_torch.ops import precision, wfm_kernel
from sdrplusplusbrown_tpu_torch.ops.spectrum import make_fft_window

from torch_parity import FS, assert_spectra_close, nfm_iq, snr_db, wfm_iq

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(params=["float32", "bf16"])
def handoff(request):
    prev = precision.get_handoff_name()
    precision.set_handoff_dtype(request.param)
    yield request.param
    precision.set_handoff_dtype(prev)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _close(a, b, min_db, what):
    a = a.detach().cpu().to(torch.complex64 if a.is_complex()
                            else torch.float32).numpy()
    b = b.detach().cpu().to(torch.complex64 if b.is_complex()
                            else torch.float32).numpy()
    assert a.shape == b.shape, what
    if np.any(a):
        assert snr_db(a, b) >= min_db, (what, snr_db(a, b))


def _planes(x, dev):
    return (torch.from_numpy(x.real.copy()).to(dev),
            torch.from_numpy(x.imag.copy()).to(dev))


@pytest.mark.parametrize("C,T", [(1, 24_000), (3, 36_000), (8, 240_000),
                                 (16, 48_000)])
def test_frontend_kernel_matches_plain(gpu, handoff, C, T):
    bank = Radio(FS, DEMOD_WFM, device="cpu")._build_vfo_shared()
    bank_gpu = Radio(FS, DEMOD_WFM)._build_vfo_shared()
    offs = np.linspace(-1.0e6, 1.0e6, C) if C > 1 else np.array([3e5])
    x = wfm_iq(2 * T, offs, seed=C)
    p, p_gpu = bank.make_params(offs), bank_gpu.make_params(offs)
    s_cpu = bank.init_state(C)
    s_gpu = bank_gpu.init_state(C)
    assert s_gpu["fused"]["tail"].is_cuda and p_gpu["fused"]["omega"].is_cuda
    n0 = mono_frontend.mono_frontend_kernel.launches
    bound = 80.0 if handoff == "float32" else 60.0
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        y_cpu, s_cpu = bank.apply(p, s_cpu, _planes(xb, "cpu"))
        # the host planes go in as they are: the bank moves them
        y_gpu, s_gpu = bank_gpu.apply(p_gpu, s_gpu, _planes(xb, "cpu"))
        assert y_gpu.is_cuda and y_gpu.dtype == y_cpu.dtype
        _close(y_cpu, y_gpu, bound, f"IF block {b}")
        for key in ("resamp", "fir"):
            _close(s_cpu[key], s_gpu[key], bound, key)
        _close(s_cpu["fused"]["tail"], s_gpu["fused"]["tail"], 200.0, "tail")
        torch.testing.assert_close(s_gpu["fused"]["phase"].cpu(),
                                   s_cpu["fused"]["phase"])
    # each CUDA launch counted: stage 0 and each chained stage, two calls
    assert mono_frontend.mono_frontend_kernel.launches == \
        n0 + 2 * mono_frontend.frontend_launches(bank_gpu.pipe())


@pytest.mark.parametrize("C", [1, 4, 8])
def test_wfm_kernels_match_plain(gpu, handoff, C):
    radio = Radio(FS, DEMOD_WFM, device="cpu")
    bank, dem = radio._build_vfo_shared(), radio.demod
    T = 48_000
    offs = np.linspace(-0.9e6, 0.9e6, C) if C > 1 else np.array([-2e5])
    x = wfm_iq(2 * T, offs, seed=10 + C)
    p = bank.make_params(offs)
    sv, sd = bank.init_state(C), dem.init_state((C,))
    sd_gpu = _to(sd, gpu)
    n2 = wfm_kernel.wfm_demod_kernel.launches
    n3 = wfm_kernel.mpx_audio_poly_kernel.launches
    bound = 70.0 if handoff == "float32" else 50.0
    for b in range(2):
        buf, sv = bank.apply(p, sv, _planes(x[b * T:(b + 1) * T], "cpu"))
        a_cpu, sd = dem.apply_planes(None, sd, buf)
        a_gpu, sd_gpu = dem.apply_planes(None, sd_gpu, buf.to(gpu))
        assert a_gpu.is_cuda and a_gpu.shape == a_cpu.shape
        _close(a_cpu, a_gpu, bound, f"audio block {b}")
        for key in ("quad", "mpx_hist", "audio_rs"):
            _close(sd[key], sd_gpu[key], bound, key)
    assert wfm_kernel.wfm_demod_kernel.launches == \
        n2 + 2 * wfm_kernel.WFM_DEMOD_LAUNCHES
    assert wfm_kernel.mpx_audio_poly_kernel.launches == n3 + 2


def _planes_of(t):
    return torch.cat([t.real, t.imag]).float() if t.is_complex() else t


def _tail_rule(t_in, y, n, dt):
    """The plain version's new tail: concat(the carried tail rounded to
    ``dt``, the stage input), the last ``n`` samples, rounded (planes)."""
    return precision.round_to(torch.cat(
        [precision.round_to(_planes_of(t_in), dt), _planes_of(y)],
        dim=1)[:, -n:], dt)


@pytest.mark.parametrize("group", ["NFM", "AM", "USB"])
def test_frontend_chains_match_plain(gpu, handoff, group):
    """K1 at multimode8's 2.4 MS/s chains (C = 4, 240 000 samples, each
    group's IF dtype) against its plain version on the same card tensors:
    the IF >= 100 dB (45 dB for a bf16 IF), every new stage tail within
    the same bar of the plain version's and exactly the plain version's
    rule on the kernels' own stage inputs; a counted launch for stage 0
    and each chained stage."""
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    bank = rb.RadioBank(2.4e6, rb.multimode8_vfos(), device=gpu)
    d, r = next((d, r) for d, r in bank.radios.items()
                if r.demod_name == group)
    pipe = r._build_vfo_shared().pipe()
    p = bank.make_params()[d]["vfo"]["fused"]
    st = bank.init_state()[d]["vfo"]
    C, T = p["omega"].shape[0], 240_000
    rng = np.random.default_rng(len(group))
    xr, xi = (torch.from_numpy(0.1 * rng.standard_normal(T)).float().to(gpu)
              for _ in range(2))
    h_dt = precision.get_handoff_dtype()
    t_dt = h_dt if C >= 16 else torch.float32
    out_dt = h_dt if group == "NFM" else torch.float32
    tails = [precision.round_to(torch.from_numpy(
        (rng.standard_normal((C, s["carry"]))
         + 1j * rng.standard_normal((C, s["carry"]))).astype(np.complex64)),
        t_dt).to(gpu) for s in pipe.stages]
    tail = st["fused"]["tail"] + 0.01
    base = pipe.base_phases(p, st["fused"]["phase"], T)
    args = (pipe, xr, xi, tail, p["omega"], base, tails, out_dt, h_dt, t_dt)
    n0 = mono_frontend.mono_frontend_kernel.launches
    got = mono_frontend.mono_frontend_kernel(*args)
    assert mono_frontend.mono_frontend_kernel.launches == \
        n0 + mono_frontend.frontend_launches(pipe)
    want = mono_frontend.mono_frontend_ref(*args)
    bound = 45.0 if out_dt == torch.bfloat16 else 100.0
    assert got[0].dtype == out_dt
    _close(want[0], got[0], bound, "IF")
    h0, kernels = pipe.taps(gpu, h_dt)
    y0 = mono_frontend.mono_mix_kernel(pipe, xr, xi, tail, p["omega"], base,
                                       h0)
    _, new, mids = mono_frontend.mono_stages_kernel(pipe, y0, tails, kernels,
                                                    out_dt, t_dt)
    for s, (stg, t, y, g, w) in enumerate(zip(pipe.stages, tails,
                                              [y0] + mids, got[1], want[1])):
        _close(w, g, bound, f"stage {s} tail")
        assert torch.equal(g, new[s])
        assert torch.equal(_planes_of(g), _tail_rule(t, y, stg["carry"],
                                                      t_dt)), s


@pytest.mark.parametrize("C", [1, 8])
def test_wfm_demod_state_matches_plain(gpu, handoff, C):
    """K2's new state on the card against its plain version on the same
    tensors (50 000 IF samples): the carried IF sample exactly; each
    halfband's tail and mpx_hist within 70 dB (50 in bf16) and exactly
    the plain version's rule on the kernels' own stage inputs (the
    discriminator's output, read back through the first launch's probe,
    and the halfbands' outputs); three launches a call."""
    radio = Radio(FS, DEMOD_WFM, device=gpu)
    pipe = radio.demod.pipes()[0]
    dt = precision.get_handoff_dtype()
    rng = np.random.default_rng(C)
    offs = np.linspace(-0.5e6, 0.5e6, C) if C > 1 else np.array([1e5])
    x = wfm_iq(50_000, offs, seed=C)
    iq = torch.from_numpy(np.concatenate(
        [np.tile(x.real, (C, 1)), np.tile(x.imag, (C, 1))]).astype(
            np.float32)).to(gpu).to(dt)
    quad = torch.from_numpy((rng.standard_normal((C, 1))
                             + 1j * rng.standard_normal((C, 1))).astype(
        np.complex64)).to(gpu)
    hbt = [torch.from_numpy(rng.standard_normal((C, len(h) - 1)).astype(
        np.float32)).to(gpu) for h in pipe.hb_taps]
    hist = torch.from_numpy(rng.standard_normal((C, pipe.K)).astype(
        np.float32)).to(gpu)
    args = (pipe, iq, 50_000, quad, hbt, hist, dt)
    n0 = wfm_kernel.wfm_demod_kernel.launches
    got = wfm_kernel.wfm_demod_kernel(*args)
    assert wfm_kernel.wfm_demod_kernel.launches == \
        n0 + wfm_kernel.WFM_DEMOD_LAUNCHES
    want = wfm_kernel.wfm_demod_ref(*args)
    bound = 70.0 if dt == torch.float32 else 50.0
    _close(want[0], got[0], bound, "L/R")
    assert torch.equal(got[1], want[1])
    lr, q, new_t, new_h, ins = wfm_kernel._wfm_demod_launches(*args,
                                                              probe=True)
    assert torch.equal(lr, got[0]) and torch.equal(q, got[1])
    for i, (t, y) in enumerate(zip(hbt, ins)):
        _close(want[2][i], got[2][i], bound, f"mpx_decim {i}")
        assert torch.equal(got[2][i], new_t[i])
        assert torch.equal(got[2][i], _tail_rule(t, y, t.shape[1], dt)), i
    _close(want[3], got[3], bound, "mpx_hist")
    assert torch.equal(got[3], _tail_rule(hist, ins[-1], pipe.K, dt))


@pytest.mark.parametrize("fft_size,interval,n", [(1024, 2_500, 5),
                                                 (2048, 5_000, 3),
                                                 (4096, 12_000, 4),
                                                 (16384, 30_000, 2),
                                                 (65536, 120_000, 2),
                                                 (256, 1_000, 3),
                                                 (1024, 1024, 256),
                                                 (8192, 20_000, 2),
                                                 (65536, 51_200, 2),
                                                 (262144, 300_000, 1)])
def test_spectrum_kernel_matches_plain(gpu, fft_size, interval, n):
    """K4 on both routes (one pass up to 4 096, four-step from 8 192) and
    across their boundary, 1 to 256 frames, keep < N (zero padding)."""
    T = n * interval
    keep = min(interval, fft_size)
    x = wfm_iq(T, np.linspace(-0.9e6, 0.9e6, 4), seed=fft_size)
    win = torch.from_numpy(make_fft_window("nuttall", keep))
    want = fft_kernel.spectrum_frames_db(*_planes(x, "cpu"), keep, interval,
                                         fft_size, -300.0, win)
    n0 = fft_kernel.spectrum_frames_db_kernel.launches
    got = fft_kernel.spectrum_frames_db(*_planes(x, gpu), keep, interval,
                                        fft_size, -300.0, win.to(gpu))
    assert got.is_cuda and got.shape == want.shape
    # each CUDA launch counted: the route's (one pass or four-step)
    assert fft_kernel.spectrum_frames_db_kernel.launches == n0 + len(
        fft_kernel.plan(fft_size, got.shape[0])["launches"])
    assert_spectra_close(want.numpy(), got.cpu().numpy())


def test_kernels_raise_instead_of_falling_back(gpu):
    x = _planes(wfm_iq(24_000, [0.0]), gpu)
    win = torch.ones(3000, device=gpu)
    with pytest.raises(ValueError):      # not a power of 2: no CUDA kernel
        fft_kernel.spectrum_frames_db(*x, 3000, 12_000, 3000, -300.0, win)
    pipe = Radio(FS, DEMOD_WFM).demod.pipes()[1]
    raw = torch.zeros((4, 2000), device=gpu)[:, ::2]
    with pytest.raises(ValueError):      # non-contiguous planes
        wfm_kernel.mpx_audio_poly(pipe, raw, 1000,
                                  torch.zeros((4, pipe.hist), device=gpu),
                                  torch.float32)


def test_radio_slice_matches_plain(gpu, handoff):
    from sdrplusplusbrown_tpu_torch.ops.spectrum import SpectrumPath
    radio = Radio(FS, DEMOD_WFM, device="cpu")
    radio_gpu = Radio(FS, DEMOD_WFM)
    sp = SpectrumPath(FS, fft_size=4096, fft_rate=200.0, device="cpu")
    sp_gpu = SpectrumPath(FS, fft_size=4096, fft_rate=200.0)
    C, T = 4, 48_000
    offs = np.linspace(-0.9e6, 0.9e6, C)
    x = wfm_iq(3 * T, offs, seed=5)
    s_cpu = radio.init_state_shared(C)
    s_gpu = radio_gpu.init_state_shared(C)
    bound = 70.0 if handoff == "float32" else 50.0
    for b in range(3):
        o = offs if b < 2 else offs + 20e3
        xb = x[b * T:(b + 1) * T]
        (a1, sp1), s_cpu = radio.apply_shared(radio.make_params_shared(o),
                                              s_cpu, _planes(xb, "cpu"),
                                              spectrum=sp)
        (a2, sp2), s_gpu = radio_gpu.apply_shared(
            radio_gpu.make_params_shared(o), s_gpu, _planes(xb, gpu),
            spectrum=sp_gpu)
        assert a2.is_cuda and sp2.is_cuda
        if b:
            _close(a1, a2, bound, f"audio block {b}")
        assert_spectra_close(sp1.numpy(), sp2.cpu().numpy())


# ---- the wide-bank NFM scanner: K5, K6, K7 -------------------------------

SCAN_T = 240_000


def _scan_offsets(C):
    """bench.py's scanner offsets (both band edges at ±1.1 MHz) with two
    channels either side of DC (bins 47 and 0)."""
    offs = np.linspace(-1.1e6, 1.1e6, C) + 917.0
    offs[C // 2 - 1:C // 2 + 1] = [-30e3, 10e3]
    return offs


@pytest.mark.parametrize("T", [SCAN_T, 384 * 30])
def test_pfb_kernel_matches_plain(gpu, handoff, T):
    """Scanner block length, and one whose last frame block is partial."""
    bank = Radio(FS, DEMOD_NFM)._build_vfo_channelized()
    pfb, post = bank.pipes()
    x = nfm_iq(2 * T, _scan_offsets(16), range(0, 16, 3), seed=T)
    Tb = 2 * T // 48
    W = post.plan(Tb)["Tb_pad"]
    st = bank.init_state(8)["chz"]
    n0 = channelizer_kernel.pfb_bins_kernel.launches
    bound = 100.0 if handoff == "float32" else 45.0
    for b in range(2):
        xr, xi = _planes(x[b * T:(b + 1) * T], gpu)
        xw = pfb.state_to_xw(st)
        args = (pfb, xr, xi, xw.real.contiguous(), xw.imag.contiguous(), W,
                precision.get_handoff_dtype(), precision.get_handoff_dtype())
        got = channelizer_kernel.pfb_bins(*args)
        want = channelizer_kernel.pfb_bins_ref(*args)
        assert got.is_cuda and got.dtype == want.dtype
        _close(want, got, bound, f"bins block {b}")
        _, st = pfb.apply(st, (xr, xi), W)
    assert channelizer_kernel.pfb_bins_kernel.launches == n0 + 4


@pytest.mark.parametrize("C", [8, 128, 256, 5])
def test_post_kernel_matches_plain(gpu, handoff, C):
    """K6 against its plain version, two blocks (each called directly and
    through ``apply``); its two CUDA launches a call, each counted, are
    ``chan_post_plan``'s."""
    bank = Radio(FS, DEMOD_NFM)._build_vfo_channelized()
    _, post = bank.pipes()
    params = bank.make_params(_scan_offsets(C))
    assert {0, 22, 26, 47} <= set(params["bin"].tolist())
    Tb = 2 * SCAN_T // 48
    plan = post.plan(Tb)
    rng = np.random.default_rng(C)
    h_dt = precision.get_handoff_dtype()
    state = bank.init_state(C)
    n0 = chan_frontend.chan_post_kernel.launches
    bound = 80.0 if handoff == "float32" else 45.0
    for b in range(2):
        bins = torch.from_numpy(rng.standard_normal(
            (96, plan["Tb_pad"])).astype(np.float32)).to(gpu).to(h_dt)
        om = params["xl"]["omega"]
        span = params["xl_sup"] * 0 + params["xl_bs"] * (post.adv0 // 128)
        tails = [precision.round_to(torch.cat([state[n].real,
                                               state[n].imag]).float(),
                                    h_dt).contiguous() for n in post.names]
        args = (post, bins, params["bin"], om, state["xl"], span,
                params["xl_bs"], tails, Tb, h_dt, h_dt)
        out, sq, nt = chan_frontend.chan_post(*args)
        out0, sq0, nt0 = chan_frontend.chan_post_ref(*args)
        m = plan["m"][-1]
        assert out.is_cuda and out.shape == out0.shape == (2 * C,
                                                           plan["n_out"])
        _close(out0[:, :m], out[:, :m], bound, f"IF block {b}")
        torch.testing.assert_close(sq, sq0, rtol=1e-5, atol=0)
        for t, t0 in zip(nt, nt0):
            _close(t0, t, bound, "tail")
        _, _, state = post.apply(params, state, bins, Tb, raw=True)
    # four calls (two a block), each counted at every CUDA launch
    per_call = chan_frontend.chan_post_plan(post, Tb, C)["launches"]
    assert chan_frontend.chan_post_kernel.launches == n0 + 4 * per_call


#: the channelized banks' post-channelizer geometries at 2.4 MS/s, d2 and
#: bandwidth FIR taps: AM 45/114, USB 17/651, DSB 18/396, CW 16/1140
POST_BANK_FORMS = {"am": (DEMOD_AM, 45, 114), "usb": (DEMOD_USB, 17, 651),
                   "dsb": (DEMOD_DSB, 18, 396), "cw": (DEMOD_CW, 16, 1140)}


@pytest.mark.parametrize("form", list(POST_BANK_FORMS))
def test_post_kernel_at_every_bandwidth_fir(gpu, handoff, form):
    """K6 at the AM, USB, DSB and CW banks' tap counts (16 channels across
    ±1.1 MHz, 0.1 s at 2.4 MS/s), against its plain version, two blocks:
    the IF and both tails >= 80 dB (45 dB in the bf16 handoff), the
    squelch sums (summed from the fir launch's per-tile partials) within
    rtol 1e-5, ``chan_post_plan``'s two launches a call.  CW's 600 bin
    frames give 300 outputs a row: one output a lane (P = 1)."""
    demod, k1, k2 = POST_BANK_FORMS[form]
    bank = Radio(FS, demod)._build_vfo_channelized()
    _, post = bank.pipes()
    assert [len(t) for t in post.taps] == [k1, k2]
    C = 16
    params = bank.make_params(np.linspace(-1.1e6, 1.1e6, C) + 917.0)
    Tb = 2 * SCAN_T // bank.M
    plan = post.plan(Tb)
    cplan = chan_frontend.chan_post_plan(post, Tb, C)
    if form == "cw":
        assert (cplan["d2"]["P"], cplan["fir"]["P"]) == (1, 1)
    rng = np.random.default_rng(k2)
    h_dt = precision.get_handoff_dtype()
    state = bank.init_state(C)
    n0 = chan_frontend.chan_post_kernel.launches
    bound = 80.0 if handoff == "float32" else 45.0
    for b in range(2):
        bins = torch.from_numpy(rng.standard_normal(
            (2 * bank.M, plan["Tb_pad"])).astype(np.float32)).to(gpu).to(h_dt)
        a_sup, rem = divmod(post.adv0, chan_frontend.SPAN)
        span = params["xl_sup"] * a_sup + params["xl_bs"] * (rem // 128)
        tails = [precision.round_to(torch.cat([state[n].real,
                                               state[n].imag]).float(),
                                    h_dt).contiguous() for n in post.names]
        args = (post, bins, params["bin"], params["xl"]["omega"],
                state["xl"], span, params["xl_bs"], tails, Tb, h_dt, h_dt)
        out, sq, nt = chan_frontend.chan_post(*args)
        out0, sq0, nt0 = chan_frontend.chan_post_ref(*args)
        m = plan["m"][-1]
        assert out.is_cuda and out.shape == out0.shape == (2 * C,
                                                           plan["n_out"])
        _close(out0[:, :m], out[:, :m], bound, f"{form} IF block {b}")
        torch.testing.assert_close(sq, sq0, rtol=1e-5, atol=0)
        for t, t0 in zip(nt, nt0):
            _close(t0, t, bound, f"{form} tail")
        _, _, state = post.apply(params, state, bins, Tb, raw=True)
    assert chan_frontend.chan_post_kernel.launches == n0 + 4 * cplan[
        "launches"]


def _post_args(gpu, C, seed):
    """K6's arguments at the scanner block: seeded bins, phases and tails
    in the handoff dtype, bench.py's offsets."""
    bank = Radio(FS, DEMOD_NFM)._build_vfo_channelized()
    _, post = bank.pipes()
    params = bank.make_params(_scan_offsets(C))
    Tb = 2 * SCAN_T // 48
    rng = np.random.default_rng(seed)
    h_dt = precision.get_handoff_dtype()
    bins = torch.from_numpy(rng.standard_normal(
        (96, post.plan(Tb)["Tb_pad"])).astype(np.float32)).to(gpu).to(h_dt)
    ph0 = torch.from_numpy(rng.uniform(-np.pi, np.pi, C).astype(np.float32)
                           ).to(gpu)
    span = params["xl_sup"] * 0 + params["xl_bs"] * (post.adv0 // 128)
    tails = [precision.round_to(torch.from_numpy(rng.standard_normal(
        (2 * C, h)).astype(np.float32)), h_dt).to(gpu).contiguous()
        for h in post.hists]
    return post, (post, bins, params["bin"], params["xl"]["omega"], ph0,
                  span, params["xl_bs"], tails, Tb, h_dt, h_dt)


@pytest.mark.parametrize("C", [128, 256, 5])
def test_post_kernel_tails_are_exact(gpu, handoff, C):
    """K6's next-call tails hold intermediate values (z and y1): each is
    exactly the plain version's rule (concat the carried tail with the
    stage's input, keep the last samples, round to the tail dtype) on the
    kernel's own z and y1 (its probe), and the wrapper returns the same;
    the kernel's y1 is the 2:1 FIR of its z within 100 dB."""
    post, args = _post_args(gpu, C, C + 1)
    t_dt = args[-1]
    m1 = args[8] // 2
    _, _, tails, (z, y1) = chan_frontend._chan_post_launches(*args,
                                                             probe=True)
    _, _, wrapper = chan_frontend.chan_post_kernel(*args)

    def planes(t):
        return torch.cat([t.real, t.imag]).float()
    want = [precision.round_to(torch.cat([args[7][0], planes(z[:, :args[8]])],
                                         dim=1)[:, -post.hists[0]:], t_dt),
            precision.round_to(torch.cat([args[7][1], planes(y1[:, :m1])],
                                         dim=1)[:, -post.hists[1]:], t_dt)]
    for got, w, v, what in zip(tails, want, wrapper, ("d2", "fir")):
        assert torch.equal(got, w), what
        assert torch.equal(got, v), what
    taps = post.dev_taps(gpu, t_dt)[0]
    ext = torch.cat([args[7][0], planes(z)], dim=1)
    y1_plain = torch.nn.functional.conv1d(ext[:, None], taps[None, None],
                                          stride=2)[:, 0]
    _close(y1_plain[:, :y1.shape[1]], planes(y1), 100.0, "y1")


@pytest.mark.parametrize("C", [8, 128, 256])
def test_fm_audio_kernel_matches_plain(gpu, handoff, C):
    """K7 against its plain version on the card, two calls: every output
    (audio, quad sample, both tails) bit-identical, at both handoffs (the
    kernel sums each output's taps in ascending order, one fused
    multiply-add each, as cuDNN's conv1d does with TF32 off, and the
    discriminator rounds as the plain version's elementwise ops); the
    launches a call (profiler) are ``fm_plan``'s."""
    from torch_parity import _chip_smoke
    radio = Radio(FS, DEMOD_NFM, squelch_enabled=True)
    pipe = radio.fm_audio_pipe()
    m_if = 5000
    rng = np.random.default_rng(C)
    h_dt = precision.get_handoff_dtype()
    gate = torch.from_numpy((np.arange(C) % 3 != 1).astype(np.float32)) \
        .to(gpu)
    st = radio.init_state((C,))
    dstate, astate = st["demod"], st["af_resamp"]
    n0 = demod_kernel.fm_audio_kernel.launches
    bound = 80.0 if handoff == "float32" else 45.0
    for b in range(2):
        dphi = 0.3 * np.sin(np.arange(5120) / 15.0) \
            + 0.05 * rng.standard_normal((C, 5120))
        z = np.exp(1j * np.cumsum(dphi, axis=1))
        iq = torch.from_numpy(np.concatenate([z.real, z.imag])
                              .astype(np.float32)).to(gpu).to(h_dt)
        q = dstate["quad"][:, 0]
        args = (pipe, iq, m_if, gate,
                precision.round_to(torch.cat([q.real, q.imag]).float(),
                                   h_dt).contiguous(),
                precision.round_to(dstate["fir"].float(), h_dt).contiguous(),
                precision.round_to(astate["resamp"].float(), h_dt)
                .contiguous(), h_dt, h_dt)
        got = demod_kernel.fm_audio(*args)
        want = demod_kernel.fm_audio_ref(*args)
        assert got[0].is_cuda and got[0].shape == want[0].shape == (C, 6144)
        _close(want[0], got[0], bound, f"audio block {b}")
        assert not got[0][gate == 0].any()     # closed from the start
        for g, w, what in zip(got, want, ("audio", "quad", "fir", "resamp")):
            if what != "audio":
                _close(w, g, bound, what)
            assert torch.equal(g, w), (what, b)
        _, dstate, astate = pipe.apply(gate, dstate, astate, iq, m_if)
    # four calls (two a block), each counted at every CUDA launch
    per_call = demod_kernel.fm_plan(pipe, m_if, C)["launches"]
    assert demod_kernel.fm_audio_kernel.launches == n0 + 4 * per_call
    _, launches = _chip_smoke().call_profile(
        lambda: demod_kernel.fm_audio(*args), reps=5)
    assert launches == per_call


def test_scanner_slice_matches_plain(gpu, handoff):
    """Radio.apply_channelized on the card (K5 → K6 → K7, one call each
    per step; K6 and K7 count each of their two CUDA launches) against the
    same Radio on the CPU, 3 blocks, a retune."""
    C = 16
    rc = Radio(FS, DEMOD_NFM, squelch_enabled=True, device="cpu")
    rg = Radio(FS, DEMOD_NFM, squelch_enabled=True)
    offs = _scan_offsets(C)
    x = nfm_iq(3 * SCAN_T, offs, range(0, C, 4), seed=3)
    s_cpu = rc.init_state_channelized(C)
    s_gpu = rg.init_state_channelized(C)
    kernels = (channelizer_kernel.pfb_bins_kernel,
               chan_frontend.chan_post_kernel, demod_kernel.fm_audio_kernel)
    n0 = [k.launches for k in kernels]
    bound = 70.0 if handoff == "float32" else 30.0
    for b in range(3):
        o = offs if b < 2 else offs + 1500.0
        xb = x[b * SCAN_T:(b + 1) * SCAN_T]
        a1, s_cpu = rc.apply_channelized(
            rc.make_params_channelized(o, squelch_level=-30.0), s_cpu,
            _planes(xb, "cpu"), mono_out=True)
        a2, s_gpu = rg.apply_channelized(
            rg.make_params_channelized(o, squelch_level=-30.0), s_gpu,
            _planes(xb, "cpu"), mono_out=True)
        assert a2.is_cuda and a2.shape == a1.shape == (C, SCAN_T // 50)
        open1 = a1.abs().amax(-1) > 0
        open2 = a2.abs().amax(-1).cpu() > 0
        assert torch.equal(open1, open2)
        assert open1.nonzero().flatten().tolist() == list(range(0, C, 4))
        _close(a1[open1], a2.cpu()[open1], bound, f"audio block {b}")
    # K5 counts a call, K6 and K7 each of their CUDA launches
    m_if = SCAN_T * 50_000 // int(FS)          # the 50 kHz IF
    post = rg._build_vfo_channelized().pipes()[1]
    per_call = (1, chan_frontend.chan_post_plan(post, 2 * SCAN_T // 48,
                                                C)["launches"],
                demod_kernel.fm_plan(rg.fm_audio_pipe(), m_if,
                                     C)["launches"])
    assert [k.launches for k in kernels] == \
        [n + 3 * k for n, k in zip(n0, per_call)]


def test_scanner_kernels_raise_instead_of_falling_back(gpu):
    radio = Radio(FS, DEMOD_NFM)
    pipe = radio.fm_audio_pipe()
    iq = torch.zeros((8, 10_000), device=gpu)[:, ::2]       # not contiguous
    z = torch.zeros
    with pytest.raises(ValueError):
        demod_kernel.fm_audio(pipe, iq, 5000, z(4, device=gpu),
                              z(8, device=gpu), z((4, 303), device=gpu),
                              z((4, 79), device=gpu), torch.float32,
                              torch.float32)
    pfb, _ = radio._build_vfo_channelized().pipes()
    xr = z(48 * 100, device=gpu)
    with pytest.raises(ValueError):                        # history on host
        channelizer_kernel.pfb_bins(pfb, xr, xr, z(264), z(264), 256,
                                    torch.float32, torch.float32)


# ---- the app's per-radio step: K8, K9, K10, K4f --------------------------

def _rows(rng, lead, n, cplx, dev):
    x = rng.standard_normal(lead + (n,))
    if cplx:
        x = x + 1j * rng.standard_normal(lead + (n,))
    return torch.from_numpy(x.astype(np.complex64 if cplx
                                      else np.float32)).to(dev)


def _path_kernel(name: str) -> np.ndarray:
    """A widened polyphase kernel of the main paths, zero bands and all:
    WFM's de-emphasis-folded 48/125 audio kernel, the 10 MS/s bank's USB
    192/625 and 16/25 VFO resamplers, and the app's 5/6 VFO resampler with
    one phase row zeroed."""
    from sdrplusplusbrown_tpu_torch.ops.resampler import RationalResampler
    if name == "folded 48/125":
        return Radio(FS, DEMOD_WFM, device="cpu").demod.audio_poly.kernel
    fs_out = {"usb 192/625": 24e3, "vfo 16/25": 50e3, "zero row 5/6": 250e3}
    fs_in = 2.4e6 if name == "zero row 5/6" else 10e6
    kern = dict(RationalResampler(fs_in, fs_out[name]).chain.named_blocks)[
        "resamp"].kernel.copy()
    if name == "zero row 5/6":
        kern[2] = 0.0
    return kern


@pytest.mark.parametrize("lead", [(), (17,)])
@pytest.mark.parametrize("K,I,D", [(304, 1, 4), (600, 1, 1), (253, 1, 1),
                                   (63, 1, 2), (97, 5, 6), (493, 48, 125),
                                   (116, 2, 3), (1, 1, 2),
                                   ("folded 48/125", 48, 125),
                                   ("usb 192/625", 192, 625),
                                   ("vfo 16/25", 16, 25),
                                   ("zero row 5/6", 5, 6)])
@pytest.mark.parametrize("cplx", [False, True])
def test_fir_rows_kernel_matches_plain(gpu, lead, K, I, D, cplx):
    """K8 on edge shapes: blocks that are no multiple of a tile, kernels
    of 1 to 872 taps, D = 1, 2, 4 and the polyphase ratios, one row and
    17, a tail longer than the block, the paths' own widened kernels with
    their zero bands (the tile loops over each phase row's nonzero band)
    and an all-zero phase row; two blocks streamed."""
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel
    if isinstance(K, str):
        kern = _path_kernel(K)
        K = kern.shape[1]
        rng = np.random.default_rng(K * 7 + D)
    else:
        rng = np.random.default_rng(K * 7 + D)
        kern = rng.standard_normal((I, K))
    kern = torch.from_numpy(kern.astype(np.float32)).to(gpu)
    hist = max(K - D, K - 1) if I > 1 else K - 1
    tail = _rows(rng, lead, hist, cplx, gpu)
    n0 = fir_kernel.fir_rows_kernel.launches
    for T in (D * 1037, D * 3):
        x = _rows(rng, lead, T, cplx, gpu)
        if (hist + T - K) // D + 1 < 1:
            continue
        got, gt = fir_kernel.fir_rows(x, tail, kern, I, D)
        want, wt = fir_kernel.fir_rows_ref(x, tail, kern, I, D)
        assert got.is_cuda and got.shape == want.shape
        _close(want, got, 100.0, f"K8 T={T}")
        assert torch.equal(gt, wt.contiguous())
        if not kern.any(dim=1).all():
            zero = got.reshape(-1, got.shape[-1] // I, I)[
                ..., ~kern.any(dim=1)]
            assert not (zero != 0).any()
        tail = gt
    assert fir_kernel.fir_rows_kernel.launches > n0


def test_fir_tile_kernels_make_one_launch(gpu):
    """K8 (the 192/625 polyphase on 8 plane rows, the 304-tap decimator
    on 8 complex rows) and K3 (WFM-8's 16 L/R rows, bf16 planes) run one
    kernel a call, as ``fir_plan``'s grid, in a profiler window
    (``call_profile`` rounds the count per call)."""
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel
    from torch_parity import _chip_smoke
    smoke = _chip_smoke()
    rng = np.random.default_rng(8)
    usb = torch.from_numpy(_path_kernel("usb 192/625").astype(np.float32))
    calls = [(_rows(rng, (8,), 8125, False, gpu),
              _rows(rng, (8,), 871, False, gpu), usb.to(gpu), 192, 625),
             (_rows(rng, (8,), 240_000, True, gpu),
              _rows(rng, (8,), 303, True, gpu),
              torch.from_numpy(rng.standard_normal((1, 304)).astype(
                  np.float32)).to(gpu), 1, 4)]
    for args in calls:
        _, launches = smoke.call_profile(
            lambda a=args: fir_kernel.fir_rows(*a), reps=5)
        assert launches == 1, (args[3], args[4], launches)
    pipe = wfm_kernel.MPXAudioPoly(
        Radio(FS, DEMOD_WFM, device="cpu").demod.audio_poly)
    raw = torch.from_numpy(rng.standard_normal((16, 12_500)).astype(
        np.float32)).to(gpu, torch.bfloat16)
    ptail = torch.zeros((16, pipe.hist), device=gpu)
    _, launches = smoke.call_profile(
        lambda: wfm_kernel.mpx_audio_poly(pipe, raw, 12_500, ptail,
                                          torch.bfloat16), reps=5)
    assert launches == 1


@pytest.mark.parametrize("lead", [(), (17,)])
@pytest.mark.parametrize("K,D", [(159, 1), (159, 2), (600, 4), (3, 1)])
def test_fir_cplx_kernel_matches_plain(gpu, lead, K, D):
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel
    rng = np.random.default_rng(K + D)
    taps = torch.from_numpy(rng.standard_normal((2, K))
                            .astype(np.float32)).to(gpu)
    tail = _rows(rng, lead, K - 1, True, gpu)
    for T in (D * 12_500, D * 5):
        x = _rows(rng, lead, T, True, gpu)
        got, gt = fir_kernel.fir_cplx(x, tail, taps, D)
        want, wt = fir_kernel.fir_cplx_ref(x, tail, taps, D)
        assert got.is_cuda and got.shape == want.shape
        _close(want, got, 100.0, f"K9 T={T}")
        assert torch.equal(gt, wt.contiguous())
        tail = gt


@pytest.mark.parametrize("lead", [(), (17,)])
@pytest.mark.parametrize("K,D", [(159, 1), (159, 2), (600, 4), (3, 1),
                                 (40, 3)])
def test_fir_cplx_kernel_is_exact_on_integers(gpu, lead, K, D):
    """K9 on integer taps and samples, where every float32 sum is exact in
    any order: the kernel equals the plain version bit for bit (each
    output, the new tail), whatever its plan (the pilot's 12 500 outputs
    and a short block), a band whose ends differ between hr and hi."""
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel
    rng = np.random.default_rng(K + 10 * D)

    def ints(shape, lo, hi, cplx=False):
        v = rng.integers(lo, hi, shape).astype(np.float32)
        if cplx:
            v = v + 1j * rng.integers(lo, hi, shape)
        return torch.from_numpy(v.astype(np.complex64 if cplx
                                         else np.float32)).to(gpu)
    taps = ints((2, K), -3, 4)
    taps[:, :K // 5] = 0.0
    taps[0, K // 5:K // 4] = 0.0
    tail = ints(lead + (K - 1,), -7, 8, True)
    for T in (D * 12_500, D * 5):
        x = ints(lead + (T,), -7, 8, True)
        got, gt = fir_kernel.fir_cplx(x, tail, taps, D)
        want, wt = fir_kernel.fir_cplx_ref(x, tail, taps, D)
        assert torch.equal(got, want), (K, D, T)
        assert torch.equal(gt, wt.contiguous())
        tail = gt


@pytest.mark.parametrize("C", [1, 3, 8])
def test_stereo_kernel_matches_plain(gpu, C):
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel
    pipe = Radio(FS, DEMOD_WFM).demod.pipes()[0]
    rng = np.random.default_rng(C)
    for T in (12_500, 300):
        mpx = torch.from_numpy(rng.standard_normal((C, T))
                               .astype(np.float32)).to(gpu)
        hist = torch.from_numpy(rng.standard_normal((C, pipe.K))
                                .astype(np.float32)).to(gpu)
        got = wfm_kernel.wfm_stereo(pipe, mpx, hist)
        want = wfm_kernel.wfm_stereo_ref(pipe, mpx, hist)
        assert got.is_cuda and got.shape == want.shape == (2, C, T)
        _close(want, got, 100.0, f"K10 T={T}")


@pytest.mark.parametrize("fft_size,keep,interval,n", [
    (1024, 1024, 2_500, 5), (4096, 3_000, 3_000, 3),
    (65536, 65536, 120_000, 2), (262144, 120_000, 120_000, 2),
    (256, 200, 333, 4), (1024, 1000, 1001, 300), (8192, 8192, 10_001, 3),
    (16384, 10_000, 12_345, 2), (65536, 65536, 65_537, 1)])
def test_spectrum_path_kernel_matches_plain(gpu, fft_size, keep, interval,
                                            n):
    """K4f at every size class on both routes, frames at exact starts
    (odd intervals: half of them not 16-byte aligned, so the one-pass
    route's scalar loads run beside its vector loads), 1 to 300 frames."""
    x = wfm_iq(n * interval, np.linspace(-0.9e6, 0.9e6, 4), seed=fft_size)
    win = torch.from_numpy(make_fft_window("nuttall", keep))
    want = fft_kernel.spectrum_path_db(torch.from_numpy(x), keep, interval,
                                       fft_size, -300.0, win)
    n0 = fft_kernel.spectrum_path_db_kernel.launches
    got = fft_kernel.spectrum_path_db(torch.from_numpy(x).to(gpu), keep,
                                      interval, fft_size, -300.0,
                                      win.to(gpu))
    assert got.is_cuda and got.shape == want.shape == (n, fft_size)
    assert fft_kernel.spectrum_path_db_kernel.launches == n0 + len(
        fft_kernel.plan(fft_size, n)["launches"])
    assert_spectra_close(want.numpy(), got.cpu().numpy())


def test_step_kernels_raise_instead_of_falling_back(gpu):
    """A CPU tensor, a non-contiguous one or a wrong dtype given to a
    kernel wrapper raises; nothing runs on the host instead."""
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel, wfm_kernel
    z = torch.zeros
    kern = z((1, 8), device=gpu)
    x = z((2, 64), device=gpu)
    tail = z((2, 7), device=gpu)
    bad = [lambda: fir_kernel.fir_rows_kernel(x, tail, kern.cpu(), 1, 1),
           lambda: fir_kernel.fir_rows_kernel(z((2, 128), device=gpu)
                                              [:, ::2], tail, kern, 1, 1),
           lambda: fir_kernel.fir_rows_kernel(x.double(), tail.double(),
                                              kern, 1, 1),
           lambda: fir_kernel.fir_cplx_kernel(
               x.to(torch.complex64), tail.to(torch.complex64),
               z((2, 8), device=gpu).double(), 1),
           lambda: fir_kernel.fir_cplx_kernel(
               x.to(torch.complex64), tail.to(torch.complex64).cpu(),
               z((2, 8), device=gpu), 1)]
    pipe = Radio(FS, DEMOD_WFM).demod.pipes()[0]
    bad += [lambda: wfm_kernel.wfm_stereo_kernel(
                pipe, z((2, 600), device=gpu)[:, ::2],
                z((2, pipe.K), device=gpu)),
            lambda: wfm_kernel.wfm_stereo_kernel(
                pipe, z((2, 300), device=gpu).half(),
                z((2, pipe.K), device=gpu)),
            lambda: fft_kernel.spectrum_path_db_kernel(
                z(2048, dtype=torch.complex64, device=gpu)[::2], 1024, 1024,
                1024, -300.0, None),
            lambda: fft_kernel.spectrum_path_db_kernel(
                z(1024, device=gpu), 1024, 1024, 1024, -300.0, None),
            lambda: fft_kernel.spectrum_path_db_kernel(
                z(1024, dtype=torch.complex64), 1024, 1024, 1024, -300.0,
                None)]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
            pytest.fail(f"call {i} did not raise")


def _app_signal(T):
    """Two stereo stations and two NFM carriers on one wideband."""
    x = wfm_iq(3 * T, [-300e3, -650e3], seed=9)
    return x + nfm_iq(3 * T, [400e3, 700e3], [0, 1], seed=10, noise=0.0)


def test_app_step_reaches_no_library_kernel(gpu, monkeypatch):
    """IQFrontEnd → Radio.apply (WFM and NFM, batch () and (8,)) on the
    card with ``F.conv1d`` and ``torch.fft`` replaced by functions that
    raise: no stage reaches cuDNN or cuFFT."""
    import torch.nn.functional as F
    from sdrplusplusbrown_tpu_torch.models.iq_frontend import IQFrontEnd

    def refuse(*a, **k):
        raise AssertionError("a library kernel was called on the card")
    monkeypatch.setattr(F, "conv1d", refuse)
    monkeypatch.setattr(torch.fft, "fft", refuse)
    fe = IQFrontEnd(FS, fft_size=65536)
    T = 240_000
    x = torch.from_numpy(_app_signal(T)[:T])
    (bb, spectra), _ = fe.apply(None, fe.init_state(), x)
    assert bb.is_cuda and spectra.shape == (2, 65536)
    for demod, batch, offs in ((DEMOD_WFM, (), -300e3),
                               (DEMOD_WFM, (8,), np.linspace(-1e6, 1e6, 8)),
                               (DEMOD_NFM, (), 400e3),
                               (DEMOD_NFM, (8,), np.linspace(-1e6, 1e6, 8))):
        r = Radio(FS, demod, squelch_enabled=True)
        a, st = r.apply(r.make_params(offs), r.init_state(batch), bb)
        assert a.is_cuda and a.shape == batch + (2, T // 50)
        assert torch.isfinite(a).all()


@pytest.mark.parametrize("batch", [(), (8,)])
@pytest.mark.parametrize("demod", [DEMOD_WFM, DEMOD_NFM])
def test_radio_apply_matches_plain(gpu, demod, batch):
    """Radio.apply on the card against the same Radio on the CPU over
    three blocks with a retune: 90 dB on the audio and every state leaf in
    the cold-start block 0, 100 dB after (the card's K8 sums the taps in
    another order than the CPU's conv1d; block 0's smallest margin was WFM
    () at 96 dB, the later blocks' 128.7 dB, on an H100).  Batched WFM
    takes K10 on the card and the per-stage section on the CPU, and only
    mpx_hist advances on the card."""
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel, wfm_kernel
    rc = Radio(FS, demod, squelch_enabled=True, device="cpu")
    rg = Radio(FS, demod, squelch_enabled=True)
    T = 48_000
    x = _app_signal(T)
    offs = {DEMOD_WFM: -300e3, DEMOD_NFM: 400e3}[demod]
    if batch:
        offs = offs + np.linspace(0.0, 7e3, 8)
    s_cpu, s_gpu = rc.init_state(batch), rg.init_state(batch)
    k10 = wfm_kernel.wfm_stereo_kernel.launches
    k8 = fir_kernel.fir_rows_kernel.launches
    for b in range(3):
        o = offs if b < 2 else offs + 2e3
        xb = torch.from_numpy(x[b * T:(b + 1) * T])
        a1, s_cpu = rc.apply(rc.make_params(o), s_cpu, xb)
        a2, s_gpu = rg.apply(rg.make_params(o), s_gpu, xb)
        assert a2.is_cuda and a2.shape == a1.shape
        _close(a1, a2, 90.0 if b == 0 else 100.0, f"audio block {b}")
        keys = ["vfo", "demod"] + (["af_resamp"] if demod == DEMOD_NFM
                                   else [])
        for key in keys:
            sub_c, sub_g = s_cpu[key], s_gpu[key]
            if key == "demod" and demod == DEMOD_WFM and batch:
                sub_c = {k: sub_c[k] for k in ("quad", "mpx_hist",
                                               "audio_rs")}
                sub_g = {k: sub_g[k] for k in sub_c}
            for (p, vc), (_, vg) in zip(_leaves(sub_c), _leaves(sub_g)):
                _close(vc, vg, 90.0 if b == 0 else 100.0, f"{key}{p}")
    assert fir_kernel.fir_rows_kernel.launches > k8
    want_k10 = 3 if (demod == DEMOD_WFM and batch) else 0
    assert wfm_kernel.wfm_stereo_kernel.launches == k10 + want_k10


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("span", [10e3, 4.9e6])
@pytest.mark.parametrize("C,K,T", [(1, 31, 4 * 1000), (4, 31, 4 * 260_017),
                                   (4, 320, 4 * 777), (64, 34, 2 * 4 * 9999),
                                   (4, 31, 1_040_000), (12, 31, 1_040_000)])
def test_fused_mix_kernel_matches_plain(gpu, C, K, T, span):
    """K11 against its plain version on the card: C = 1, 4, 12, 64, K up
    to 320, output counts off every block size, the short (M <= 1024) and
    the spanned twiddle, channels near the centre and across the band, the
    10 MS/s bank's shape (C = 4, T = 1 040 000) and three groups' worth of
    channels on it (C = 12: chunks of 8 and 4): >= 100 dB."""
    from sdrplusplusbrown_tpu_torch.ops import fused_frontend as ff
    rng = np.random.default_rng(C + K)
    D = 2 if C == 64 else 4
    x = (rng.standard_normal((2, T)) * 0.3).astype(np.float32)
    tail = (rng.standard_normal((2, K - 1)) * 0.3).astype(np.float32)
    p = ff.fused_params(np.linspace(-span, 0.98 * span, C) + 917.0, 10e6, D)
    args = [torch.from_numpy(a).to(gpu) for a in (x[0], x[1], tail[0],
                                                   tail[1])]
    args += [torch.from_numpy((np.hanning(K + 2)[1:-1] / K)
                              .astype(np.float32)).to(gpu), D,
             p["omega"].to(gpu),
             torch.from_numpy(rng.uniform(-3, 3, C).astype(np.float32))
             .to(gpu), p["omega_dec"].to(gpu), p["omega_dec_span"].to(gpu)]
    n0 = ff.fused_mix_kernel.launches
    got = ff.fused_mix_kernel(*args)
    want = ff.fused_mix_ref(*args)
    torch.cuda.synchronize()
    assert ff.fused_mix_kernel.launches == n0 + 1
    assert got.shape == (2 * C, T // D) and got.is_cuda
    _close(want, got, 100.0, "K11")


@pytest.mark.parametrize("R,T", [(1, 37), (4, 1500), (4, 2400), (64, 2400),
                                 (4, 1), (4, 31), (64, 33), (4, 2496),
                                 (64, 2496)])
def test_agc_kernel_matches_plain(gpu, R, T):
    """K12 against its plain version on the card (zero samples, frozen
    rows aside, the ramp's end inside the block, env at its 2^30 cap;
    rows shorter than a 32-sample batch and a partial last batch): the
    output >= 100 dB, the state exact (both round every operation on its
    own); and the output bit-identical to the plain version on the CPU,
    whose divisions are IEEE divisions as the kernel's (on the card the
    plain ramp multiplies by 1/4800)."""
    from sdrplusplusbrown_tpu_torch.ops import agc
    rng = np.random.default_rng(R * T)
    blk = agc.AGC(attack=50 / 24e3, decay=5 / 24e3)
    x = (rng.standard_normal((R, T)) * np.linspace(0.01, 3, T)) \
        .astype(np.float32)
    x[:, T // 3:T // 3 + 5] = 0.0
    amp = rng.uniform(0.01, 1.0, R).astype(np.float32)
    env = rng.choice(np.array([0, 4000, 4799, 1 << 30], np.int32), R)
    for frozen in (False, True):
        host = (blk, torch.from_numpy(x), torch.from_numpy(amp),
                torch.from_numpy(env), frozen)
        args = (blk,) + tuple(t.to(gpu) for t in host[1:4]) + (frozen,)
        y, a, e = agc.agc_rows_kernel(*args)
        yr, ar, er = agc.agc_rows_ref(*args)
        torch.cuda.synchronize()
        _close(yr, y, 100.0, f"K12 frozen={frozen}")
        assert torch.equal(a, ar) and torch.equal(e, er)
        yc, ac, ec = agc.agc_rows_ref(*host)
        assert torch.equal(y.cpu(), yc) and torch.equal(a.cpu(), ac)
        assert torch.equal(e.cpu(), ec)


def _multimode_banks(fs, device):
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    vfos = rb.multimode8_vfos()
    return rb.RadioBank(fs, vfos, device=device), vfos


@pytest.mark.parametrize("fs", [2.4e6, 10e6])
def test_multimode_step_matches_cpu(gpu, handoff, fs):
    """RadioBank.apply (multimode8) on the card against the same bank on
    the CPU, three blocks: audio and every state leaf >= 80 dB (60 dB in
    bf16, a bf16 ulp either side of a tie).  The NFM audio of the
    cold-start block 0 is compared from 20 ms on: before, the
    discriminator works on the IF rising out of the filters' transient,
    whose rounding decides its angle (card against CPU 17.3 dB there at
    10 MS/s on an H100; the JAX package's own routes agree to 36.8 dB,
    tests/test_torch_radio_bank.py)."""
    from torch_parity import multimode_iq
    bc, vfos = _multimode_banks(fs, "cpu")
    bg, _ = _multimode_banks(fs, gpu)
    T = bc.in_multiple * (2 if fs < 3e6 else 1)
    x = multimode_iq(3 * T, fs, [(v.demod_id, v.offset_hz) for v in vfos])
    sc, sg = bc.init_state(), bg.init_state()
    bound = 80.0 if handoff == "float32" else 60.0
    for b in range(3):
        xb = torch.from_numpy(x[b * T:(b + 1) * T])
        oc, sc = bc.apply(bc.make_params(), sc, xb, mono_out=True)
        og, sg = bg.apply(bg.make_params(), sg, xb, mono_out=True)
        for d in oc:
            assert og[d].is_cuda and og[d].shape == oc[d].shape
            assert torch.isfinite(og[d]).all()
            skip = 960 if b == 0 and d == DEMOD_NFM else 0
            _close(oc[d][:, skip:], og[d][:, skip:], bound,
                   f"audio {d} block {b}")
            for p, vc in _leaves(sc[d]):
                vg = dict(_leaves(sg[d]))[p]
                if vc.dtype == torch.int32:
                    assert torch.equal(vc, vg.cpu()), p
                else:
                    _close(vc, vg, bound, f"state {d}{p} block {b}")


def test_multimode_banks_reach_only_their_kernels(gpu, monkeypatch):
    """Both multimode8 banks step on the card with every kernel's plain
    version, ``F.conv1d`` and ``torch.fft.fft`` replaced by functions that
    raise; with K11 refused the 10 MS/s bank raises, and with K1 refused
    the 2.4 MS/s one."""
    import torch.nn.functional as F
    from sdrplusplusbrown_tpu_torch.ops import (agc, fir_kernel,
                                                fused_frontend)

    def refuse(*a, **k):
        raise AssertionError("a plain version or a library kernel ran")
    for mod, name in ((F, "conv1d"), (torch.fft, "fft"),
                      (fused_frontend, "fused_mix_ref"),
                      (agc, "agc_rows_ref"), (fir_kernel, "fir_rows_ref"),
                      (mono_frontend, "mono_frontend_ref"),
                      (demod_kernel, "fm_audio_ref")):
        monkeypatch.setattr(mod, name, refuse)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        80_000).astype(np.complex64) * 0.1)
    for fs, kernel_mod, kernel in ((2.4e6, mono_frontend,
                                    "mono_frontend_kernel"),
                                   (10e6, fused_frontend,
                                    "fused_mix_kernel")):
        bank, _ = _multimode_banks(fs, gpu)
        T = bank.in_multiple * (4 if fs < 3e6 else 1)
        out, st = bank.apply(bank.make_params(), bank.init_state(), x[:T],
                             mono_out=True)
        assert all(o.is_cuda and torch.isfinite(o).all()
                   for o in out.values())
        with monkeypatch.context() as m:
            m.setattr(kernel_mod, kernel, refuse)
            with pytest.raises(AssertionError):
                bank.apply(bank.make_params(), st, x[:T], mono_out=True)


# ---- channelizer64: K5's critical form, the row-batched spectrum K4r -----

def _chz_blocks(T, M, n, seed):
    from torch_parity import planes
    rng = np.random.default_rng(seed)
    x = 0.1 * (rng.standard_normal(n * T) + 1j * rng.standard_normal(n * T))
    t = np.arange(n * T)
    x = x + 0.3 * np.exp(2j * np.pi * (3 * 10e6 / M + 1e3) * t / 10e6)
    return [planes(x[b * T:(b + 1) * T].astype(np.complex64))
            for b in range(n)]


@pytest.mark.parametrize("M,trans_frac", [(8, 0.2), (16, 2.0), (48, 0.2),
                                          (64, 0.2), (64, 2.0)])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_pfb_critical_kernel_matches_plain(gpu, M, trans_frac, out):
    """K5's critical form against its plain version: M = 8, 16, 48, 64,
    tpp = 19 and 2, a width of 1000 frames (not a multiple of the kernel's
    32), float32 and bf16 bins; >= 100 dB (bf16: 45 dB), two calls with
    the state carried."""
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    ch = PolyphaseChannelizer(10e6, M, trans_frac=trans_frac)
    pipe = ch.pfb()
    assert pipe.tpp == (19 if trans_frac < 1 else 2)
    T = M * 1000
    st = ch.init_state()
    n0 = channelizer_kernel.pfb_critical_bins_kernel.launches
    for b, (xr, xi) in enumerate(_chz_blocks(T, M, 2, seed=M)):
        xw = pipe.state_to_xw(st)
        args = (pipe, xr.to(gpu), xi.to(gpu), xw.real.contiguous(),
                xw.imag.contiguous(), 1000, torch.float32, out)
        got = channelizer_kernel.pfb_bins(*args)
        want = channelizer_kernel.pfb_bins_ref(*args)
        assert got.is_cuda and got.dtype == out and got.shape == (2 * M,
                                                                  1000)
        _close(want, got, 100.0 if out == torch.float32 else 45.0,
               f"bins block {b}")
        _, st = ch.apply_planes(st, (xr, xi))        # one more launch
    assert channelizer_kernel.pfb_critical_bins_kernel.launches == n0 + 4


def _identity_pipe(pipe):
    """A copy of a PFB configuration whose DFT matrix is the identity: its
    plain version's bins are then the folded frames (signed)."""
    import copy
    p = copy.copy(pipe)
    p.cos = np.eye(pipe.M, dtype=np.float32)
    p.sin = np.zeros((pipe.M, pipe.M), np.float32)
    p._dev = {}
    return p


#: K5's oversampled forms by path: the channelized bank's demod at 2.4 MS/s
PFB_BANK_FORMS = {"scanner128": DEMOD_NFM, "am160": DEMOD_AM,
                  "ssb100": DEMOD_USB, "cw800": DEMOD_CW}


def _pfb_path_case(form, dev):
    """(pipe, (xr, xi, xwr, xwi), width) at a path's full width: the
    channelized bank's PFB at 0.1 s of 2.4 MS/s (scanner128 and
    scanner256 share NFM's, M = 48, 10 240 frames; AM's M = 160, SSB's
    M = 100 and CW's M = 800 run the large-M kernel), channelizer64's
    (2^21 samples at 10 MS/s, 32 768) or the critical form at M = 128
    (2^21 samples, 16 384 frames, the large-M kernel)."""
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    if form in PFB_BANK_FORMS:
        bank = Radio(FS, PFB_BANK_FORMS[form])._build_vfo_channelized()
        pipe, post = bank.pipes()
        T = 240_000
        W = post.plan(2 * T // pipe.M)["Tb_pad"]
    else:
        M = 128 if form == "critical128" else 64
        pipe = PolyphaseChannelizer(10e6, M).pfb()
        T = 1 << 21
        W = T // M
    rng = np.random.default_rng(T)
    x = tuple(torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
        np.float32)).to(dev) for n in (T, T, pipe.n_hist, pipe.n_hist))
    return pipe, x, W


@pytest.mark.parametrize("form", ["scanner128", "channelizer64", "am160",
                                  "ssb100", "cw800", "critical128"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
def test_pfb_kernels_at_path_widths(gpu, form, tdt):
    """K5 (scanner128/256's 10 240 frames, 2×-oversampled; the
    channelized AM, SSB and CW banks' at M = 160, 100 and 800, every row)
    and K5c (channelizer64's 32 768, critical; M = 128's 16 384) against
    their plain versions at the path's full width, both tap dtypes, on the
    T/h valid frames (the large-M kernel leaves the columns past its
    valid tiles unwritten): float32 bins >= 100 dB, bf16 bins >= 45 dB,
    one launch a call; the folded frames (the kernel's probe) within
    120 dB of the plain version's (its bins through an identity DFT
    matrix, the sign undone).  Above M = 64 the plan is the large-M
    kernel's: wgmma on all 2M rows."""
    pipe, x, W = _pfb_path_case(form, gpu)
    V = x[0].shape[0] // pipe.h
    na = pipe.dft_parts(gpu, tdt)[1]
    plan = channelizer_kernel.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na,
                                       2 * pipe.M, V)
    assert plan["big"] == (pipe.M > 64)
    assert plan.get("wg", False) == (pipe.M > 64)
    fn = channelizer_kernel.pfb_critical_bins_kernel if pipe.critical \
        else channelizer_kernel.pfb_bins_kernel
    for out, bound in ((torch.float32, 100.0), (torch.bfloat16, 45.0)):
        n0 = fn.launches
        got = fn(pipe, *x, W, tdt, out)
        assert fn.launches == n0 + 1
        want = channelizer_kernel.pfb_bins_ref(pipe, *x, W, tdt, out)
        assert got.dtype == out and got.shape == (2 * pipe.M, W)
        _close(want[:, :V], got[:, :V], bound, f"{form} bins {out}")
    _, fold = channelizer_kernel._launch_pfb(pipe, *x, W, tdt,
                                             torch.float32, probe=True)
    plain = channelizer_kernel.pfb_bins_ref(_identity_pipe(pipe), *x, W,
                                            tdt, torch.float32)
    if not pipe.critical:
        M = pipe.M
        odd = (torch.arange(2 * M, device=gpu) % M) % 2 == 1
        even = torch.arange(W, device=gpu) % 2 == 0
        plain = torch.where(odd[:, None] & even[None], -plain, plain)
    _close(plain[:, :V], fold[:, :V], 120.0, f"{form} folded frames")


def _bank_bins(M, seed):
    """Sixteen bin indices at M (a bank's C = 16): bins 0 and M − 1, a
    duplicate, odd and even bins (the oversampled form's sign)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, M, 16)
    b[:4] = [0, M - 1, 1, 1]
    return torch.from_numpy(b.astype(np.int32))


@pytest.mark.parametrize("form", ["am160", "ssb100", "cw800"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
def test_pfb_big_gathered_rows_match_plain(gpu, form, tdt):
    """The large-M kernel on a bank's row list [bin | M + bin] (16 bins:
    0, M − 1, a duplicate, odd ones) at the bank's 0.1 s width, against
    the plain version's rows on the T/h valid frames: float32 taps
    >= 100 dB with float32 bins, bf16 taps >= 60 dB with bf16 bins
    (phase 27's bars); the mma.sync route (under 128 rows)."""
    pipe, x, W = _pfb_path_case(form, gpu)
    V = x[0].shape[0] // pipe.h
    b = _bank_bins(pipe.M, pipe.M)
    rows = torch.cat([b, b + pipe.M]).to(gpu)
    na = pipe.dft_parts(gpu, tdt)[1]
    assert not channelizer_kernel.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na,
                                           32, V)["wg"]
    out, bound = ((torch.float32, 100.0) if tdt == torch.float32
                  else (torch.bfloat16, 60.0))
    got = channelizer_kernel.pfb_bins(pipe, *x, W, tdt, out, rows)
    want = channelizer_kernel.pfb_bins_ref(pipe, *x, W, tdt, out, rows)
    assert got.shape == want.shape == (32, W)
    _close(want[:, :V], got[:, :V], bound, f"{form} gathered rows")
    full = channelizer_kernel.pfb_bins_ref(pipe, *x, W, tdt, out)
    assert torch.equal(want, full[rows.long()])


def test_pfb_big_retune_reuses_the_plan(gpu, handoff):
    """Two blocks of the AM bank's ``apply`` with a retune between: one
    K5 call each, no new matrix or plan state (the PFB's device cache
    unchanged), each block's bins the plain version's rows of its own
    bins (K5 called again with the captured rows)."""
    bank = Radio(FS, DEMOD_AM)._build_vfo_channelized()
    pfb, post = bank.pipes()
    T = pfb.M * 300
    x = wfm_iq(2 * T, [0.0], seed=4)
    offs = np.linspace(-1.0e6, 1.0e6, 16) + 317.0
    st = bank.init_state(16)
    seen = []
    orig = channelizer_kernel.pfb_bins

    def spy(*a):
        seen.append(a)
        return orig(*a)
    channelizer_kernel.pfb_bins = spy
    try:
        for blk, o in enumerate((offs, offs + 25e3)):
            _, _, st = bank.apply(bank.make_params(o), st,
                                  _planes(x[blk * T:(blk + 1) * T], gpu))
            if blk == 0:
                keys = set(pfb._dev)
    finally:
        channelizer_kernel.pfb_bins = orig
    assert set(pfb._dev) == keys and len(seen) == 2
    for blk, (o, a) in enumerate(zip((offs, offs + 25e3), seen)):
        rows = a[8]
        k = np.mod(np.round(o / bank.out_samplerate).astype(np.int64),
                   pfb.M)
        assert rows.cpu().tolist() == list(k) + list(k + pfb.M)
        V = a[1].shape[0] // pfb.h
        got = channelizer_kernel.pfb_bins(*a)
        want = channelizer_kernel.pfb_bins_ref(*a)
        _close(want[:, :V], got[:, :V],
               100.0 if handoff == "float32" else 45.0, f"block {blk}")


def test_pfb_big_leaves_columns_past_the_valid_tiles(gpu):
    """Into a NaN-filled buffer: every valid frame written and finite,
    the columns past the plan's last tile still NaN, on both routes."""
    for form, R in (("cw800", 32), ("critical128", 256)):
        pipe, x, W = _pfb_path_case(form, gpu)
        T = pipe.M * 37 if pipe.critical else pipe.h * 74
        x = (x[0][:T], x[1][:T]) + x[2:]
        V = T // pipe.h
        W = V + 200
        rows = torch.arange(R, dtype=torch.int32, device=gpu)
        na = pipe.dft_parts(gpu, torch.bfloat16)[1]
        p = channelizer_kernel.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na, R,
                                        V)
        end = p["tiles"] * p["nt"]
        assert V <= end < W
        buf = torch.full((R, W), float("nan"), device=gpu)
        got = channelizer_kernel._launch_pfb(pipe, *x, W, torch.bfloat16,
                                             torch.float32, rows, out=buf)
        assert got is buf
        assert torch.isfinite(buf[:, :end]).all(), form
        assert torch.isnan(buf[:, end:]).all(), form


@pytest.mark.parametrize("form", ["scanner128", "channelizer64"])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
def test_pfb_big_fold_matches_the_register_kernels(gpu, form, tdt):
    """The large-M kernel's folded frames (its probe, on a large-M plan
    at M = 48 and 64, both routes) bit for bit the register-resident
    kernels' (the same ascending-i fmaf chain) on the valid frames; its
    bins >= 100 dB (float32 taps) against theirs."""
    pipe, x, _ = _pfb_path_case(form, gpu)
    T = pipe.M * 300
    x = (x[0][:T], x[1][:T]) + x[2:]
    V = T // pipe.h
    W = V + 40
    na = pipe.dft_parts(gpu, tdt)[1]
    a, fa = channelizer_kernel._launch_pfb(pipe, *x, W, tdt, torch.float32,
                                           probe=True)
    for R in (2 * pipe.M, 32):
        plan = channelizer_kernel._big_plan(pipe.M, pipe.tpp, pipe.h, W, na,
                                            R, V)
        assert plan["wg"] == (R >= 128)
        rows = torch.arange(R, dtype=torch.int32, device=gpu)
        b, fb = channelizer_kernel._launch_pfb(
            pipe, *x, W, tdt, torch.float32, rows, probe=True, plan=plan)
        assert torch.equal(fa[:, :V], fb[:, :V]), (form, R)
        if tdt == torch.float32:
            _close(a[:R, :V], b[:, :V], 100.0, f"{form} R = {R}")


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16],
                         ids=["float32 taps", "bf16 taps"])
def test_pfb_in_place_route_matches_staged(gpu, tdt):
    """``pfb_plan``'s last resort, no input span in shared memory (the fold
    reads the stream in place), gives the staged route's bins and folded
    frames bit for bit, both forms, in both register kernels (bf16 taps:
    the warp-specialised one; float32 taps: the three-part one) and in the
    large-M kernel on both routes (a bank's 32 rows on mma.sync at AM's
    M = 160; every row on wgmma at the critical M = 128; ``staged`` off);
    and the largest tpp the earlier kernel took at M = 8, 2×-oversampled
    (2 381 taps a branch), which needs that route, launches and holds
    100 dB against the plain version."""
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        OversampledChannelizer
    for form in ("scanner128", "channelizer64"):
        pipe, x, _ = _pfb_path_case(form, gpu)
        T = pipe.M * 256
        x, W = (x[0][:T], x[1][:T]) + x[2:], T // pipe.h
        na = pipe.dft_parts(gpu, tdt)[1]
        p = channelizer_kernel.pfb_plan(pipe.M, pipe.tpp, pipe.h, W, na)
        assert p["ws"] == (tdt == torch.bfloat16) and p["nbuf"] > 0
        a = channelizer_kernel._launch_pfb(pipe, *x, W, tdt, torch.float32,
                                           probe=True)
        b = channelizer_kernel._launch_pfb(
            pipe, *x, W, tdt, torch.float32, probe=True,
            plan=dict(p, nt=16, nbuf=0, tiles=-(-W // 16)))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), form
    for form, R in (("am160", 32), ("critical128", 256)):
        pipe, x, _ = _pfb_path_case(form, gpu)
        T = pipe.M * 200
        x, V = (x[0][:T], x[1][:T]) + x[2:], T // pipe.h
        na = pipe.dft_parts(gpu, tdt)[1]
        rows = torch.arange(R, dtype=torch.int32, device=gpu)
        p = channelizer_kernel.pfb_plan(pipe.M, pipe.tpp, pipe.h, V, na, R,
                                        V)
        if channelizer_kernel.pfb_big_smem(
                pipe.M, pipe.tpp, pipe.h, p["nt"], p["kc"], p["rbp"], na,
                True, p["wg"], p["ring"], p["threads"]) > \
                channelizer_kernel.SMEM_MAX:
            assert not p["staged"]      # the three-part wgmma route
            continue
        a, b = (channelizer_kernel._launch_pfb(
            pipe, *x, V, tdt, torch.float32, rows, probe=True,
            plan=dict(p, staged=staged)) for staged in (True, False))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), form
    rng = np.random.default_rng(8)
    proto = np.hanning(8 * 2381 + 2)[1:-1] * (
        1 + 0.1 * rng.standard_normal(8 * 2381))
    pipe = OversampledChannelizer(1e6, 8, proto).pfb()
    assert pipe.tpp == 2381
    na = pipe.dft_parts(gpu, tdt)[1]
    assert channelizer_kernel.pfb_plan(8, 2381, 4, 300, na)["nbuf"] == 0
    x = tuple(torch.from_numpy((0.1 * rng.standard_normal(n)).astype(
        np.float32)).to(gpu) for n in (8 * 150, 8 * 150, pipe.n_hist,
                                       pipe.n_hist))
    got = channelizer_kernel.pfb_bins(pipe, *x, 300, tdt, torch.float32)
    want = channelizer_kernel.pfb_bins_ref(pipe, *x, 300, tdt,
                                           torch.float32)
    _close(want, got, 100.0, "M = 8, tpp = 2381")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft_rows_kernel_matches_plain(gpu, dtype):
    """K4r on [M, F, 1024] views of a [2M, W] stack, W past the valid
    frames (the kernel reads through the row stride): one wrapper call for
    every row, against its plain version on the same values."""
    M, F, W = 64, 3, 3 * 1024 + 640
    rng = np.random.default_rng(int(dtype == torch.bfloat16))
    bins = torch.from_numpy(rng.standard_normal((2 * M, W))
                            .astype(np.float32)).to(gpu).to(dtype)
    xr = bins[:M, :F * 1024].reshape(M, F, 1024)
    xi = bins[M:, :F * 1024].reshape(M, F, 1024)
    n0 = fft_kernel.fft_power_db_planes_kernel.launches
    got = fft_kernel.fft_power_db_planes(xr, xi, 1024)
    want = fft_kernel.fft_power_db_planes_ref(xr.cpu(), xi.cpu(), 1024)
    assert got.is_cuda and got.shape == (M, F, 1024)
    assert fft_kernel.fft_power_db_planes_kernel.launches == n0 + len(
        fft_kernel.plan(1024, M * F)["launches"])
    assert_spectra_close(want.numpy(), got.cpu().numpy())
    # one row, and rows given as contiguous frames
    one = fft_kernel.fft_power_db_planes(xr[5], xi[5], 1024)
    assert_spectra_close(want[5].numpy(), one.cpu().numpy())
    cont = fft_kernel.fft_power_db_planes(xr.contiguous(), xi.contiguous(),
                                          1024)
    assert_spectra_close(want.numpy(), cont.cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,M,F", [(256, 4, 3), (4096, 3, 2), (8192, 2, 2),
                                   (65536, 2, 1)])
def test_fft_planes_routes_match_plain(gpu, dtype, N, M, F):
    """K4r at every route and across their boundary: [M, F, N] views of
    a [2M, W] stack whose rows run past the frames, read in place."""
    W = F * N + 640
    rng = np.random.default_rng(N + M)
    bins = torch.from_numpy(rng.standard_normal((2 * M, W))
                            .astype(np.float32)).to(gpu).to(dtype)
    xr = bins[:M, :F * N].reshape(M, F, N)
    xi = bins[M:, :F * N].reshape(M, F, N)
    n0 = fft_kernel.fft_power_db_planes_kernel.launches
    got = fft_kernel.fft_power_db_planes(xr, xi, N)
    want = fft_kernel.fft_power_db_planes_ref(xr.cpu(), xi.cpu(), N)
    assert got.is_cuda and got.shape == (M, F, N)
    assert fft_kernel.fft_power_db_planes_kernel.launches == n0 + len(
        fft_kernel.plan(N, M * F)["launches"])
    assert_spectra_close(want.numpy(), got.cpu().numpy())


def test_fft_routes_make_their_planned_launches(gpu):
    """In a profiler window, after the twiddle table is made: K4r at
    channelizer64's shapes runs one kernel a call (the one-pass route, no
    scratch), K4 at 4 096 points one, K4f at two 65 536-point frames two
    (the four-step), as ``plan`` says (``call_profile`` rounds the
    count per call: the profiler drops an event now and then)."""
    from torch_parity import _chip_smoke
    smoke = _chip_smoke()
    bins = torch.zeros((128, 32 * 1024 + 512), dtype=torch.bfloat16,
                       device=gpu)
    v = (bins[:64, :32 * 1024].reshape(64, 32, 1024),
         bins[64:, :32 * 1024].reshape(64, 32, 1024))
    x = torch.zeros(240_000, dtype=torch.complex64, device=gpu)
    win = torch.ones(65536, device=gpu)
    planes = (x.real.contiguous(), x.imag.contiguous())
    calls = [(lambda: fft_kernel.fft_power_db_planes(*v, 1024), 1024, 2048),
             (lambda: fft_kernel.spectrum_frames_db(*planes, 4096, 12_000,
                                                    4096, -300.0, None),
              4096, 20),
             (lambda: fft_kernel.spectrum_path_db(x, 65536, 120_000, 65536,
                                                  -300.0, win), 65536, 2)]
    for fn, N, n in calls:
        _, launches = smoke.call_profile(fn, reps=5)
        assert launches == len(fft_kernel.plan(N, n)["launches"]), \
            (N, n, launches)
    assert fft_kernel.plan(1024, 2048)["route"] == "one-pass"


def test_channelizer64_step_matches_cpu(gpu, handoff):
    """The channelizer64 step (M = 64, 10 MS/s, T = 2^21) on the card
    against the same step on the CPU, three steps: spectra as the CPU
    tests compare them in the float32 handoff; in bf16 the card's and the
    CPU's float32 sums round some bins a bf16 ulp apart (2^-8), so there
    the power spectra (linear) agree to >= 40 dB SNR.  State exact, K5c
    and K4r once a step."""
    from torch_parity import _chip_smoke
    smoke = _chip_smoke()
    T = smoke.CHZ_T
    chc, stepc = smoke.channelizer64("cpu", T)
    chg, stepg = smoke.channelizer64(gpu, T)
    xr, xi = smoke.channelizer64_noise(3 * T)
    sc, sg = chc.init_state(), chg.init_state()
    kern = (channelizer_kernel.pfb_critical_bins_kernel,
            fft_kernel.fft_power_db_planes_kernel)
    n0 = [k.launches for k in kern]
    for b in range(3):
        xb = (torch.from_numpy(xr[b * T:(b + 1) * T]),
              torch.from_numpy(xi[b * T:(b + 1) * T]))
        spc, sc = stepc(sc, xb)
        spg, sg = stepg(sg, xb)
        assert spg.is_cuda and spg.shape == spc.shape == (64, 32, 1024)
        assert torch.isfinite(spg).all()
        want, got = spc.numpy(), spg.cpu().numpy()
        if handoff == "float32":
            assert_spectra_close(want, got)
        else:
            lin = snr_db(10.0 ** (want / 10.0), 10.0 ** (got / 10.0))
            assert lin >= 40.0, lin
        assert torch.equal(sg.cpu(), sc)
    assert [k.launches for k in kern] == [n + 3 for n in n0]


def test_channelizer64_reaches_no_library_kernel(gpu, monkeypatch):
    """The channelizer64 step on the card with ``torch.fft.fft`` and both
    plain versions replaced by functions that raise."""
    from torch_parity import _chip_smoke

    def refuse(*a, **k):
        raise AssertionError("a plain version or a library kernel ran")
    for mod, name in ((torch.fft, "fft"), (fft_kernel,
                                           "fft_power_db_planes_ref"),
                      (channelizer_kernel, "pfb_bins_ref")):
        monkeypatch.setattr(mod, name, refuse)
    smoke = _chip_smoke()
    ch, step = smoke.channelizer64(gpu, 1 << 17)
    xr, xi = smoke.channelizer64_noise(1 << 17)
    spec, st = step(ch.init_state(), (torch.from_numpy(xr),
                                      torch.from_numpy(xi)))
    assert spec.is_cuda and spec.shape == (64, 2, 1024)
    assert torch.isfinite(spec).all() and st.is_cuda
    y, _ = ch.apply(None, st, torch.from_numpy(xr + 1j * xi))
    assert y.is_cuda and y.shape == (64, 2048)


def test_channelizer64_kernels_raise_instead_of_falling_back(gpu):
    """A geometry K5's critical form cannot take (odd M, one tap per
    branch) raises NotImplementedError on the card, while M = 128 (the
    large-M kernel) runs and holds its plain version on the CPU to 100 dB
    (float32 bins); a CPU, a non-contiguous or a wrong-dtype tensor given
    to the new wrappers raises ValueError."""
    from sdrplusplusbrown_tpu_torch.ops.channelizer import \
        PolyphaseChannelizer
    for M, tf in ((128, 0.2), (15, 0.2), (16, 5.0)):
        ch = PolyphaseChannelizer(10e6, M, trans_frac=tf)
        x = torch.zeros(M * 256, dtype=torch.complex64, device=gpu)
        if M == 128:
            rng = np.random.default_rng(M)
            x = torch.from_numpy((rng.standard_normal(M * 256) + 1j
                                  * rng.standard_normal(M * 256)).astype(
                                      np.complex64))
            ch_cpu = PolyphaseChannelizer(10e6, M, trans_frac=tf,
                                          device="cpu")
            n0 = channelizer_kernel.pfb_critical_bins_kernel.launches
            got, st = ch.apply_planes(ch.init_state(), x.to(gpu),
                                      out_dtype=torch.float32)
            want, st0 = ch_cpu.apply_planes(ch_cpu.init_state(), x,
                                            out_dtype=torch.float32)
            assert channelizer_kernel.pfb_critical_bins_kernel.launches \
                == n0 + 1
            _close(want, got, 100.0, "M = 128 bins")
            assert torch.equal(st.cpu(), st0)
            continue
        with pytest.raises(NotImplementedError):
            ch.apply_planes(ch.init_state(), x)
    ch = PolyphaseChannelizer(10e6, 64)
    pipe = ch.pfb()
    z = torch.zeros
    xr = z(64 * 256, device=gpu)
    hist = z(pipe.n_hist, device=gpu)
    f32 = torch.float32
    bad = [lambda: channelizer_kernel.pfb_critical_bins_kernel(
               pipe, xr, xr, hist.cpu(), hist, 256, f32, f32),
           lambda: channelizer_kernel.pfb_critical_bins_kernel(
               pipe, z(2 * 64 * 256, device=gpu)[::2], xr, hist, hist, 256,
               f32, f32),
           lambda: channelizer_kernel.pfb_critical_bins_kernel(
               pipe, xr.double(), xr.double(), hist, hist, 256, f32, f32),
           lambda: channelizer_kernel.pfb_critical_bins_kernel(
               pipe, xr, xr, hist, hist, 256, f32, torch.float16),
           lambda: channelizer_kernel.pfb_bins_kernel(
               pipe, xr, xr, hist, hist, 256, f32, f32)]
    planes = z((2, 4096), device=gpu)
    v = planes[:, :2048].reshape(2, 2, 1024)
    bad += [lambda: fft_kernel.fft_power_db_planes_kernel(v.cpu(), v.cpu(),
                                                          1024),
            lambda: fft_kernel.fft_power_db_planes_kernel(
                v[..., ::2], v[..., ::2], 512),
            lambda: fft_kernel.fft_power_db_planes_kernel(
                v.half(), v.half(), 1024),
            lambda: fft_kernel.fft_power_db_planes_kernel(
                v, v.to(torch.bfloat16), 1024)]
    for i, fn in enumerate(bad):
        with pytest.raises(ValueError):
            fn()
            pytest.fail(f"call {i} did not raise")


def test_served_app_matches_cpu(gpu, handoff, tmp_path, monkeypatch):
    """The served app (tests/test_torch_app.py's session: a WFM, an NFM
    and a squelched NFM radio, the DC blocker on, a retune and an
    NFM → USB switch before block 3) on the card against the port's own
    app on the CPU, four blocks: each radio's audio >= 80 dB (45 dB in
    the bf16 handoff), the squelched radio exactly zero on both, the
    spectra by ``assert_spectra_close``; K4f, K8 and K9 launched, each
    wrapper's count its calls' planned CUDA launches."""
    import json
    import os
    from sdrplusplusbrown_tpu_torch.app import SDRApp
    from sdrplusplusbrown_tpu_torch.ops import fir_kernel
    from torch_parity import (SERVED_BLOCKS, SERVED_RADIOS, _chip_smoke,
                              run_served, served_capture, served_config)
    cap = str(tmp_path / "baseband_100000000Hz_10-00-00_01-01-2024.wav")
    served_capture(cap)
    wrappers = {"K4f": (fft_kernel, "spectrum_path_db_kernel"),
                "K8": (fir_kernel, "fir_rows_kernel"),
                "K9": (fir_kernel, "fir_cplx_kernel")}
    runs, calls = {}, {t: [] for t in wrappers}
    for dev in ("cpu", gpu):
        root = str(tmp_path / str(dev))
        os.makedirs(root)
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(served_config(cap), f)
        app = SDRApp(root, run_pump=False, device=dev)
        if dev == gpu:
            n0 = {t: getattr(*w).launches for t, w in wrappers.items()}
            for t, (mod, name) in wrappers.items():
                orig = getattr(mod, name)
                monkeypatch.setattr(
                    mod, name, lambda *a, _o=orig, _t=t: (
                        calls[_t].append(a), _o(*a))[1])
        runs[dev] = run_served(app, root, True)
        monkeypatch.undo()
    for t, (mod, name) in wrappers.items():
        n = getattr(mod, name).launches - n0[t]
        planned = sum(_chip_smoke().planned_launches(t, a) for a in calls[t])
        assert n >= 1 and n == planned, (t, n, planned)
    bar = 80.0 if handoff == "float32" else 45.0
    for b in range(SERVED_BLOCKS):
        for r in SERVED_RADIOS:
            want, got = runs["cpu"]["audio"][b][r], runs[gpu]["audio"][b][r]
            assert got.shape == want.shape, (b, r)
            if r == "Q":
                assert not want.any() and not got.any(), b
            else:
                assert snr_db(want, got) >= bar, (b, r, snr_db(want, got))
        assert_spectra_close(runs["cpu"]["lines"][b], runs[gpu]["lines"][b])


# ---- K13 (the sequential loops) and K12's complex form --------------------

def _loop_input(rng, R, T, w0=0.3, noise=0.1):
    k = np.arange(T)
    x = np.exp(1j * (w0 * k[None] + rng.uniform(0, 6, (R, 1))
                     + 0.4 * np.sin(2 * np.pi * k[None] / 700.0)))
    x = x + noise * (rng.standard_normal((R, T))
                     + 1j * rng.standard_normal((R, T)))
    return torch.from_numpy(x.astype(np.complex64))


def _exact(got, want, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, dict):
            for k in w:
                assert torch.equal(g[k], w[k]), (what, k)
        elif isinstance(g, (tuple, list)):
            _exact(g, w, f"{what}[{i}]")
        else:
            assert torch.equal(g, w), (what, i, (g.float() - w.float())
                                       .abs().max() if g.shape == w.shape
                                       else g.shape)


@pytest.mark.parametrize("R,T", [(1, 6250), (8, 6250), (3, 37), (2, 4097)])
def test_pll_kernel_matches_plain(gpu, R, T):
    """K13's PLL form on the WFM pilot's shapes (one radio's 6 250-sample
    MPX block, 8 rows; a tile and a partial one): the VCO and the state
    bit-identical to the plain loop on the card."""
    from sdrplusplusbrown_tpu_torch.ops import pll
    blk = pll.PLL(0.2, init_freq=0.3, min_freq=0.296, max_freq=0.304)
    rng = np.random.default_rng(R * T)
    x = _loop_input(rng, R, T).to(gpu)
    ph = torch.from_numpy(rng.uniform(-3, 3, R).astype(np.float32)).to(gpu)
    fr = torch.full((R,), 0.3, dtype=torch.float32, device=gpu)
    got = pll.pll_rows_kernel(blk, x, ph, fr)
    want = pll.pll_rows_ref(blk, x, ph, fr)
    torch.cuda.synchronize()
    _exact(got, want, "K13 pll")


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("R,T", [(1, 250), (1, 2500), (3, 2500)])
def test_costas_kernel_matches_plain(gpu, order, R, T):
    """K13's Costas form at the RDS demod's block shapes (250 and 2 500
    samples at 5 kS/s), every order: bit-identical to the plain loop."""
    from sdrplusplusbrown_tpu_torch.ops import costas
    blk = costas.Costas(order, 0.01, init_freq=1.49, min_freq=1.34,
                        max_freq=1.64)
    rng = np.random.default_rng(order * T + R)
    x = _loop_input(rng, R, T, w0=1.5).to(gpu)
    ph = torch.zeros(R, dtype=torch.float32, device=gpu)
    fr = torch.full((R,), 1.49, dtype=torch.float32, device=gpu)
    got = costas.costas_rows_kernel(blk, x, ph, fr)
    want = costas.costas_rows_ref(blk, x, ph, fr)
    torch.cuda.synchronize()
    _exact(got, want, f"K13 costas {order}")


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("R,T", [(1, 250), (1, 2500), (3, 2500),
                                 (2, 20_000)])
def test_mm_kernel_matches_plain(gpu, cplx, R, T):
    """K13's M&M form at the RDS shapes (real; complex as well) and at
    20 000 samples (five of the kernel's input tiles, as the decoders'
    0.1 s blocks take several): symbols, valid, the new tail, state and
    offset bit-identical to the plain loop, from a carried state
    mid-stream (negative offset, history)."""
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery as cr
    blk = cr.MMClockRecovery(5000.0 / 1187.5, 1e-6, 0.01, 0.01,
                             complex_data=cplx)
    rng = np.random.default_rng(T + cplx)
    t = np.arange(T) / blk.omega
    sym = np.sign(rng.standard_normal((R, int(t[-1]) + 2)))
    x = np.stack([np.convolve(s[t.astype(int)], np.ones(5) / 5, "same")
                  for s in sym]) + 0.05 * rng.standard_normal((R, T))
    if cplx:
        x = x + 1j * np.roll(x, 3, axis=-1)
    dt = torch.complex64 if cplx else torch.float32
    x = torch.from_numpy(x).to(dt).to(gpu)
    st = _to(blk.init_state((R,)), gpu)
    st["offset"] = torch.full((R,), -2, dtype=torch.int32, device=gpu)
    st["phase"] = torch.full((R,), 0.37, dtype=torch.float32, device=gpu)
    st["tail"] = (torch.randn(R, blk.K - 1, dtype=dt,
                              generator=torch.Generator().manual_seed(T))
                  .to(gpu))
    got = cr.mm_rows_kernel(blk, x, st)
    want = cr.mm_rows_ref(blk, x, st)
    torch.cuda.synchronize()
    assert got[0][1].sum() > T // 5
    _exact(got, want, f"K13 mm cplx={cplx}")


@pytest.mark.parametrize("R,T", [(1, 250), (4, 2400), (3, 33)])
def test_agc_complex_kernel_matches_plain(gpu, R, T):
    """K12's complex form at RDSDemod's [1, 250] and the AM carrier AGC's
    [4, 2 400] (zeros, frozen, the ramp's end): the output >= 100 dB and
    the state exact, as the real form."""
    from sdrplusplusbrown_tpu_torch.ops import agc
    rng = np.random.default_rng(R * T + 1)
    blk = agc.AGC(attack=50 / 15e3, decay=5 / 15e3)
    x = ((rng.standard_normal((R, T)) + 1j * rng.standard_normal((R, T)))
         * np.linspace(0.01, 3, T)).astype(np.complex64)
    x[:, T // 3:T // 3 + 5] = 0.0
    amp = rng.uniform(0.01, 1.0, R).astype(np.float32)
    env = rng.choice(np.array([0, 4000, 4799, 1 << 30], np.int32), R)
    for frozen in (False, True):
        args = (blk, torch.from_numpy(x).to(gpu), torch.from_numpy(amp)
                .to(gpu), torch.from_numpy(env).to(gpu), frozen)
        y, a, e = agc.agc_cplx_rows_kernel(*args)
        yr, ar, er = agc.agc_rows_ref(*args)
        torch.cuda.synchronize()
        _close(yr, y, 100.0, f"K12c frozen={frozen}")
        assert torch.equal(a, ar) and torch.equal(e, er)


@pytest.mark.parametrize("R,T", [(1, 15_000), (1, 72_000), (2, 72_013)])
def test_agc_complex_kernel_at_the_decoders_blocks(gpu, R, T):
    """K12c at a Meteor module's 0.1 s block (1 x 15 000, a partial last
    batch) and RyFi's (1 x 72 000), and rows with a partial last batch
    at that length, from a carried state (the envelope mid-stream, the
    ramp's end inside the block or past it), with zero and subnormal
    samples across batch edges: the output >= 100 dB and the state
    exact, as at the other shapes."""
    from sdrplusplusbrown_tpu_torch.ops import agc
    rng = np.random.default_rng(T + R)
    blk = agc.AGC(set_point=1.0, attack=0.1, decay=0.1, max_gain=10e6)
    x = ((rng.standard_normal((R, T)) + 1j * rng.standard_normal((R, T)))
         * np.linspace(0.05, 2, T)).astype(np.complex64)
    tiny = np.float32(1e-40)                     # subnormal
    for n, edge in enumerate((32, 4096, 32 * (T // 64), 32 * (T // 32)
                              - 32)):
        straddle, after = (0.0, tiny + 1j * tiny)[::1 - 2 * (n % 2)]
        x[:, edge - 3:edge + 2] = straddle
        x[:, edge + 2:edge + 5] = after
    x[:, -2:] = 0.0
    amp = rng.uniform(0.2, 1.5, R).astype(np.float32)
    env = np.array([3000, 1 << 20][:R], np.int32)
    for frozen in (False, True):
        args = (blk, torch.from_numpy(x).to(gpu), torch.from_numpy(amp)
                .to(gpu), torch.from_numpy(env).to(gpu), frozen)
        y, a, e = agc.agc_cplx_rows_kernel(*args)
        yr, ar, er = agc.agc_rows_ref(*args)
        torch.cuda.synchronize()
        _close(yr, y, 100.0, f"K12c {R}x{T} frozen={frozen}")
        assert torch.equal(a, ar) and torch.equal(e, er)


def test_loop_kernels_raise_instead_of_falling_back(gpu):
    """On a CUDA tensor the loops launch K13 or raise: a custom Costas
    detector has no kernel form, and a mistyped block is refused."""
    from sdrplusplusbrown_tpu_torch.ops import agc, costas, pll
    x = torch.ones(1, 16, dtype=torch.complex64, device=gpu)
    z = torch.zeros(1, dtype=torch.float32, device=gpu)
    blk = costas.Costas(2, 0.01, error_fn=lambda v: v.real)
    with pytest.raises(NotImplementedError):
        costas.costas_rows(blk, x, z, z)
    with pytest.raises(ValueError):
        pll.pll_rows(pll.PLL(0.1), x.real.contiguous(), z, z)
    with pytest.raises(ValueError):
        agc.agc_cplx_rows_kernel(agc.AGC(), x.real.contiguous(), z,
                                 torch.zeros(1, dtype=torch.int32,
                                             device=gpu), False)


@pytest.mark.parametrize("form", ["pll", "costas", "mm", "agc_cplx"])
def test_loop_kernels_chain_clock(gpu, form):
    """With ``clk`` each sequential kernel fills every row's chain cycles
    and nanoseconds (at least one cycle a step, at most the SM clock's
    rate) and returns the same bits as without it."""
    from sdrplusplusbrown_tpu_torch.ops import agc, clock_recovery, costas, pll
    R, T = 2, 1000
    rng = np.random.default_rng(7)
    x = _loop_input(rng, R, T).to(gpu)
    z = torch.zeros(R, dtype=torch.float32, device=gpu)
    if form == "pll":
        fn, args = pll.pll_rows_kernel, (pll.PLL(0.2, init_freq=0.3), x, z,
                                         z + 0.3)
    elif form == "costas":
        fn, args = costas.costas_rows_kernel, (costas.Costas(2, 0.01), x, z,
                                               z)
    elif form == "mm":
        blk = clock_recovery.MMClockRecovery(4.21, complex_data=True)
        fn, args = (clock_recovery.mm_rows_kernel,
                    (blk, x, _to(blk.init_state((R,)), gpu)))
    else:
        fn, args = agc.agc_cplx_rows_kernel, (
            agc.AGC(), x, z + 0.5, torch.zeros(R, dtype=torch.int32,
                                               device=gpu), False)
    clk = torch.zeros(R, 2, dtype=torch.int64, device=gpu)
    got, want = fn(*args, clk), fn(*args)
    torch.cuda.synchronize()
    _exact(got, want, f"{form} with its chain clock")
    cycles, ns = clk[:, 0].cpu().numpy(), clk[:, 1].cpu().numpy()
    steps = args[0].max_out(T) if form == "mm" else T
    assert (cycles >= steps).all() and (ns > 0).all(), clk
    assert (cycles / ns < 2.5).all(), clk       # GHz: below any SM clock


@pytest.mark.parametrize("kw", [dict(pll_mode="scan"), dict(rds=True),
                                dict(stereo=False)],
                         ids=["scan", "rds", "mono"])
def test_radio_forms_match_cpu(gpu, kw):
    """Radio.apply in the per-stage WFM forms on the card (K13's PLL, the
    RDS tap) against the same on the host CPU: audio (and the RDS
    baseband) >= 80 dB after the first block's 20 ms of transient."""
    from torch_parity import rds_fm_iq
    fs = 2.4e6
    radios = {d: Radio(fs, DEMOD_WFM, device=d, **kw) for d in ("cpu", gpu)}
    B = radios["cpu"].in_multiple * max(1, round(0.05 * fs / radios[
        "cpu"].in_multiple))
    x = torch.from_numpy(rds_fm_iq(3 * B, fs, offset=-300e3, seed=8))
    out = {}
    for d, r in radios.items():
        p, s, ys = r.make_params(-300e3), r.init_state(()), []
        for b in range(3):
            y, s = r.apply(p, s, x[b * B:(b + 1) * B])
            ys.append(y if isinstance(y, tuple) else (y,))
        out[d] = ys
    for b in range(3):
        for i, (want, got) in enumerate(zip(out["cpu"][b], out[gpu][b])):
            skip = (960 if i == 0 else 100) if b == 0 else 0
            _close(want[..., skip:], got[..., skip:], 80.0, (b, i))


# ---------------------------------------------------------------------
# the network path's device parts: the EFFT compressor and the feed

def _efft_signal(T: int, fs: float, seed: int) -> np.ndarray:
    """Light noise and two carriers (tests/test_torch_efft_device.py's
    signal at ``fs``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / fs
    return (0.001 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))
            + 0.05 * np.exp(2j * np.pi * fs / 13 * t)
            + 0.02 * np.exp(2j * np.pi * -fs / 6 * t)).astype(np.complex64)


@pytest.mark.parametrize("fs,frames", [(40_000.0, 24), (2_400_000.0, 32)])
def test_efft_device_matches_cpu(gpu, fs, frames):
    """EFFTCompressorDevice on the card against the host CPU, two calls
    with the state carried: readys, count and every frame's nonzero
    pattern equal, the emits >= 60 dB, the rings >= 80 dB."""
    from sdrplusplusbrown_tpu_torch.ops.efft_device import (
        EFFTCompressorDevice, efft_decompress)
    blocks = {d: EFFTCompressorDevice(fs, device=d) for d in ("cpu", gpu)}
    n = blocks["cpu"].fft_size
    x = torch.from_numpy(_efft_signal(2 * frames * n, fs, 3))
    st = {d: b.init_state() for d, b in blocks.items()}
    for c in range(2):
        out = {}
        for d, b in blocks.items():
            out[d], st[d] = b.apply(None, st[d],
                                    x[c * frames * n:(c + 1) * frames * n])
        (ec, rc), (eg, rg) = out["cpu"], out[gpu]
        assert eg.device.type == "cuda" and eg.dtype == torch.complex64
        assert torch.equal(rg.cpu(), rc)
        assert torch.equal(eg.cpu() != 0, ec != 0), c
        _close(ec, eg, 60.0, ("emits", c))
        assert int(st[gpu]["count"]) == int(st["cpu"]["count"])
        for k in ("clean_freq", "clean_mag", "win_mag"):
            _close(st["cpu"][k], st[gpu][k], 80.0, (k, c))
    td = efft_decompress(eg)
    assert td.device.type == "cuda"
    np.testing.assert_allclose(td.cpu().numpy(),
                               efft_decompress(ec).numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["none", "int8", "efft"])
def test_device_feed_matches_cpu(gpu, mode):
    """DeviceFeed on the card against the host CPU: none and int8 exact,
    efft >= 60 dB, the same byte accounting."""
    from sdrplusplusbrown_tpu_torch.io.feed import DeviceFeed
    fs = 96_000.0
    feeds = {d: DeviceFeed(mode, samplerate=fs, device=d)
             for d in ("cpu", gpu)}
    x = _efft_signal(1 << 17, fs, 5)
    for i in range(0, len(x), 1 << 14):
        a = feeds["cpu"].push(x[i:i + (1 << 14)])
        b = feeds[gpu].push(x[i:i + (1 << 14)])
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert b.device.type == "cuda"
        if mode == "efft":
            _close(a, b, 60.0, i)
        else:
            assert torch.equal(b.cpu(), a), i
    assert feeds[gpu].stats() == feeds["cpu"].stats()


# ---- K14 (LogMMSE's frame recursions) and K15 (the linear recurrence) -----

@pytest.mark.parametrize("fs,wideband,batch,frames,count,hold", [
    (2.4e6, True, (), 5, 7, None),     # the served IF NR, the ring filling
    (2.4e6, True, (), 5, 230, None),   # the ring full
    (2.4e6, True, (), 5, 230, True),   # a held block
    (24_000.0, False, (2,), 20, 1990, False),   # the AF NR, filling to full
])
def test_logmmse_frames_kernel_matches_plain(gpu, fs, wideband, batch,
                                             frames, count, hold):
    """K14 against its plain version on the card at the served IF NR's
    2.4 MS/s (nFFT 96 000, H 200) and the AF NR's 24 kS/s at batch 2: the
    rings, sums, counters and has_prev bit-identical, the gains and X
    >= 120 dB.  The plain version runs first: it copies the rings, while
    the kernel writes its slots in place and hands the rings over (the
    given state's are emptied and marked)."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    from torch_parity import logmmse_frames_inputs
    core = plm.LogMMSE(fs, wideband=wideband)
    st, sig = logmmse_frames_inputs(core, batch, frames, count, seed=count)
    st = {k: v.to(gpu) for k, v in st.items()}
    sig = sig.to(gpu)
    h = None if hold is None else torch.tensor(hold, device=gpu)
    before = {k: v.clone() for k, v in st.items()}
    want_st, want_hw = plm.logmmse_frames_ref(core, st, sig, h)
    for k, v in st.items():      # the plain version copies
        assert torch.equal(v, before[k]), k
    ptr = st["hist"].data_ptr()
    got_st, got_hw = plm.logmmse_frames_kernel(core, st, sig, h)
    torch.cuda.synchronize()
    assert got_st["hist"].data_ptr() == ptr            # written in place
    for k in plm.RINGS:
        assert st[k].numel() == 0 and st[k].handed_over, k
    for k in ("hist", "dev_hist", "sums", "devs", "count", "pos",
              "has_prev"):
        assert torch.equal(got_st[k], want_st[k]), k
    _close(want_hw, got_hw, 120.0, "K14 hw")
    _close(want_st["Xk_prev"], got_st["Xk_prev"], 120.0, "K14 Xk_prev")


def test_logmmse_frames_dispatch_launches_once_a_block(gpu):
    """``LogMMSE.apply`` on CUDA tensors reaches K14 once a block (and
    never its plain version)."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    nr = plm.IFNRLogMMSE(96_000.0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(40_000) + 1j
                          * rng.standard_normal(40_000))
                         .astype(np.complex64)).to(gpu)
    st = nr.prime(_to(nr.init_state(()), gpu), x[:12 * nr.core.Slen])
    n0 = plm.logmmse_frames_kernel.launches
    for _ in range(3):
        _, st = nr.apply(None, st, x[:4 * nr.core.len2])
    assert plm.logmmse_frames_kernel.launches - n0 == 3


def _no_plain_k14(monkeypatch):
    """K14's plain halves raise when they run (on the card's path)."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm

    def refuse(*a, **k):
        raise AssertionError("a plain version of K14 ran on the card")
    monkeypatch.setattr(plm, "logmmse_frames_ref", refuse)
    monkeypatch.setattr(plm.LogMMSE, "_push_history", refuse)


@pytest.mark.parametrize("wideband", [True, False])
def test_logmmse_prime_launches_k14_once(gpu, monkeypatch, wideband):
    """``LogMMSE.prime`` on CUDA tensors is one K14 launch and no plain
    version; its history is the plain ``_push_history``'s on the same
    card's spectra bit for bit, its Xk_prev and has_prev the given
    state's."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    core = plm.LogMMSE(2.4e6 if wideband else 24_000.0, wideband=wideband)
    batch = () if wideband else (2,)
    rng = np.random.default_rng(4)
    n = core.NOISE_FRAMES * core.Slen
    x0 = torch.from_numpy((rng.standard_normal(batch + (n,)) + 1j
                           * rng.standard_normal(batch + (n,)))
                          .astype(np.complex64)).to(gpu)
    st = _to(core.init_state(batch), gpu)
    st["Xk_prev"] += 0.5
    _, sig = core._spectra(x0.reshape(batch + (core.NOISE_FRAMES,
                                               core.Slen)))
    want = core._push_history(dict(st), sig, None)
    before = {k: st[k].clone() for k in ("Xk_prev", "has_prev")}
    _no_plain_k14(monkeypatch)
    n0 = plm.logmmse_frames_kernel.launches
    got = core.prime(st, x0)
    torch.cuda.synchronize()
    assert plm.logmmse_frames_kernel.launches - n0 == 1
    for k in ("hist", "dev_hist", "sums", "devs", "count", "pos"):
        assert torch.equal(got[k], want[k]), k
    for k, v in before.items():
        assert torch.equal(got[k], v), k


def test_logmmse_handed_over_state_raises(gpu, monkeypatch):
    """A LogMMSE state whose rings K14 took cannot be used again: the IF
    NR's ``apply`` on it raises, naming the hand-over, and the state it
    returned goes on to give the plain chain's result (three blocks
    against the plain version's three on the same inputs)."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    nr = plm.IFNRLogMMSE(96_000.0)
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal(60_000) + 1j
                          * rng.standard_normal(60_000))
                         .astype(np.complex64)).to(gpu)
    st0 = nr.prime(_to(nr.init_state(()), gpu), x[:12 * nr.core.Slen])
    blk = [x[i * 4 * nr.core.len2:(i + 1) * 4 * nr.core.len2]
           for i in range(3)]
    plain = {k: v.clone() for k, v in st0.items()}
    outs = []
    with monkeypatch.context() as m:   # the plain chain: rings copied
        m.setattr(plm, "logmmse_frames", plm.logmmse_frames_ref)
        for b in blk:
            y, plain = nr.apply(None, plain, b)
            outs.append(y)
    st = st0
    for i, b in enumerate(blk):
        y, st_next = nr.apply(None, st, b)
        with pytest.raises(RuntimeError, match="handed over"):
            nr.apply(None, st, b)
        _close(outs[i], y, 100.0, f"block {i}")
        st = st_next
    for k in ("hist", "dev_hist", "sums", "devs", "count", "pos"):
        assert torch.equal(st[k], plain[k]), k


@pytest.mark.parametrize("case", range(5))
def test_linear_recurrence_kernel_matches_plain(gpu, case):
    """K15 against its plain version (the doubling scan) on the card at
    the paths' poles and rows (tests/torch_parity.py:recurrence_cases)
    and at the served RDS block's 480 000 samples: >= 100 dB at the DC
    blocker, 130 dB at the noise blanker, 80 dB elsewhere, and at least
    as close as the plain version to the float64 recurrence."""
    from sdrplusplusbrown_tpu_torch.ops import recurrence as prec
    from torch_parity import recurrence_cases, recurrence_chunks_model
    cases = list(recurrence_cases())
    rng = np.random.default_rng(8)
    T = 480_000
    x = ((rng.standard_normal(T) + 1j * rng.standard_normal(T) + 0.1)
         * 0.3).astype(np.complex64)[None]
    r = np.float32(50.0 / 2.4e6)
    cases.append(("served RDS block", float(np.float32(1) - r), x * r,
                  np.array([0.03 - 0.01j], np.complex64)))
    name, a, b, y0 = cases[case]
    ta = torch.from_numpy(a).to(gpu) if isinstance(a, np.ndarray) else a
    tb, ty0 = torch.from_numpy(b).to(gpu), torch.from_numpy(y0).to(gpu)
    got = prec.linear_recurrence_kernel(ta, tb, ty0)
    want = prec.linear_recurrence_ref(ta, tb, ty0)
    torch.cuda.synchronize()
    wide = np.complex128 if np.iscomplexobj(b) else np.float64
    truth = recurrence_chunks_model(
        np.asarray(a, np.float32).astype(np.float64), b.astype(wide),
        y0.astype(wide))
    got, want = got.cpu().numpy(), want.cpu().numpy()
    bar = {"front end DC": 100.0, "noise blanker": 130.0,
           "served RDS block": 100.0}.get(name, 80.0)
    assert snr_db(want, got) >= bar, name
    assert snr_db(truth, got) >= snr_db(truth, want) - 0.5, name


@pytest.mark.parametrize("case", range(4))
def test_linear_recurrence_fused_forms_match_the_unfused_route(gpu, case):
    """K15's "dc" and "nb" forms on the card against the unfused route:
    K15's "scan" form, then the blocks' torch ops (``dc_route``,
    ``nb_route``) on the same card, bit-identical (out and state); and
    against the plain version (the doubling scan, the same ops) >= 100 dB
    (DC) and 130 dB (NB)."""
    from sdrplusplusbrown_tpu_torch.ops import recurrence as prec
    from torch_parity import recurrence_fused_cases
    name, form, pole, gain, level, x, y0 = list(
        recurrence_fused_cases())[case]
    tx, ty0 = torch.from_numpy(x).to(gpu), torch.from_numpy(y0).to(gpu)
    lvl = torch.tensor(level, device=gpu) if level == 4.0 else level
    extra = (gain,) if form == "dc" else (gain, lvl)
    route = prec.dc_route if form == "dc" else prec.nb_route
    n0 = prec.linear_recurrence_kernel.launches
    got = prec.linear_recurrence_kernel(pole, tx, ty0, form, *extra)
    assert prec.linear_recurrence_kernel.launches - n0 == 1
    unfused = route(prec.linear_recurrence_kernel, pole, tx, ty0, *extra)
    plain = prec.linear_recurrence_ref(pole, tx, ty0, form, *extra)
    torch.cuda.synchronize()
    for g, u in zip(got, unfused):
        assert g.shape == u.shape and g.dtype == u.dtype, name
        assert torch.equal(g, u), (name, snr_db(u.cpu().numpy(),
                                                g.cpu().numpy()))
    bar = 100.0 if form == "dc" else 130.0
    for g, p in zip(got, plain):
        _close(p, g, bar, f"{name} against the plain version")


def test_recurrence_kernels_raise_instead_of_falling_back(gpu):
    """K14 and K15 refuse CPU tensors and wrong dtypes on the card."""
    from sdrplusplusbrown_tpu_torch.ops import logmmse as plm
    from sdrplusplusbrown_tpu_torch.ops import recurrence as prec
    b = torch.zeros(2, 64, device=gpu)
    with pytest.raises(ValueError):
        prec.linear_recurrence_kernel(0.5, b.double(), torch.zeros(2,
                                                                  device=gpu))
    with pytest.raises(ValueError):
        prec.linear_recurrence_kernel(torch.ones(2, 64, device=gpu).double(),
                                      b, torch.zeros(2, device=gpu))
    with pytest.raises(ValueError):
        prec.linear_recurrence_kernel(0.5, b, torch.zeros(2))
    with pytest.raises(ValueError):
        prec.linear_recurrence_kernel(0.5, b, torch.zeros(2, device=gpu),
                                      "fused")
    with pytest.raises(ValueError):          # a fused form's pole is scalar
        prec.linear_recurrence_kernel(torch.ones(2, 64, device=gpu), b,
                                      torch.zeros(2, device=gpu), "dc")
    core = plm.LogMMSE(96_000.0, wideband=True)
    st = _to(core.init_state(()), gpu)
    sig = torch.ones(2, core.nFFT, device=gpu)
    with pytest.raises(ValueError):
        plm.logmmse_frames_kernel(core, st, sig.cpu(), None)
    with pytest.raises(ValueError):
        plm.logmmse_frames_kernel(core, st, sig[:, :-1], None)


# ---- the TX path's kernels at its shapes -------------------------------

def test_tx_kernels_at_tx_shapes(gpu):
    """K8 at ServerTxPath's 6 k -> 48 k resampler on a 200 ms wire block,
    K9 at SSBMod's 651 complex taps on 48 000 samples and K12 at
    TxChain's AGC on 48 000 samples, each against its plain version (K8
    and K9 on the card, >= 100 dB and the tail exact; K12 against the
    plain loop on the host CPU, bit for bit: its loop takes ~13 s a call
    on the card)."""
    from sdrplusplusbrown_tpu_torch.models import trx
    from sdrplusplusbrown_tpu_torch.ops import agc, fir_kernel
    from sdrplusplusbrown_tpu_torch.ops.fir import device_taps
    from sdrplusplusbrown_tpu_torch.ops.mod import SSBMod
    rng = np.random.default_rng(28)

    def cplx(*shape):
        return torch.from_numpy((rng.standard_normal(shape) + 1j
                                 * rng.standard_normal(shape)).astype(
            np.complex64)).to(gpu)
    poly = dict(trx.ServerTxPath(trx.LoopbackTransmitter(), device=gpu)
                .resamp.chain.named_blocks)["resamp"]
    assert (poly.interp, poly.decim) == (8, 1)
    args = (cplx(1200), cplx(poly.tpp - 1),
            device_taps(poly, poly.kernel, gpu), poly.interp, poly.decim)
    y, t = fir_kernel.fir_rows_kernel(*args)
    yr, tr = fir_kernel.fir_rows_ref(*args)
    _close(yr, y, 100.0, "K8 TX resampler")
    assert y.shape == (9600,) and torch.equal(t, tr)
    ssb = SSBMod(SSBMod.USB, 2800.0, 48_000.0)
    args = (cplx(48_000), cplx(650), device_taps(ssb.fir, ssb.fir.taps, gpu),
            1)
    y, t = fir_kernel.fir_cplx_kernel(*args)
    yr, tr = fir_kernel.fir_cplx_ref(*args)
    _close(yr, y, 100.0, "K9 SSBMod")
    assert y.shape == (48_000,) and torch.equal(t, tr)
    blk = trx.TxChain("USB").agc
    x = (0.3 * rng.standard_normal((1, 48_000))).astype(np.float32)
    host = (blk, torch.from_numpy(x), torch.ones(1), torch.zeros(
        1, dtype=torch.int32), False)
    got = agc.agc_rows_kernel(*(blk,) + tuple(v.to(gpu) for v in host[1:4])
                              + (False,))
    for g, w in zip(got, agc.agc_rows_ref(*host)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("mode", ["USB", "LSB", "FM", "AM"])
def test_tx_path_matches_cpu(gpu, mode):
    """TxChain on the card (K12, then K9 for SSB) and ServerTxPath's
    packets (K8) against the same blocks on the host CPU, three carried
    blocks: >= 80 dB (the FM phasors within 1e-4), each kernel launched
    a block."""
    from sdrplusplusbrown_tpu_torch.models import trx
    from sdrplusplusbrown_tpu_torch.ops import agc, fir_kernel
    rng = np.random.default_rng(29)
    audio = (0.3 * rng.standard_normal((3, 4800))).astype(np.float32)
    wire = (0.5 * np.exp(2j * np.pi * rng.random((3, 1200)))).astype(
        np.complex64)
    out = {}
    for dev in (gpu, torch.device("cpu")):
        n0 = (agc.agc_rows_kernel.launches,
              fir_kernel.fir_cplx_kernel.launches,
              fir_kernel.fir_rows_kernel.launches)
        ch = trx.TxChain(mode)
        init, ys = ch.init_state(()), []
        st = {"agc": _to(init["agc"], dev),
              "mod": None if init["mod"] is None else _to(init["mod"], dev)}
        for a in audio:
            y, st = ch.apply(None, st, torch.from_numpy(a).to(dev))
            ys.append(y.cpu())
        lb = trx.LoopbackTransmitter()
        path = trx.ServerTxPath(lb, prebuffer_ms=20.0, device=dev)
        for w in wire:
            path.push_wire_block(w)
        out[dev.type] = (ys, lb.blocks)
        if dev.type == "cuda":
            n = (agc.agc_rows_kernel.launches - n0[0],
                 fir_kernel.fir_cplx_kernel.launches - n0[1],
                 fir_kernel.fir_rows_kernel.launches - n0[2])
            assert n == (3, 3 if mode in ("USB", "LSB") else 0, 3), n
    for g, c in zip(out["cuda"][0], out["cpu"][0]):
        if mode == "FM":
            assert float((g - c).abs().max()) <= 1e-4
        else:
            _close(c, g, 80.0, f"TxChain {mode}")
    assert len(out["cuda"][1]) == len(out["cpu"][1]) > 0
    for g, c in zip(*(out[k][1] for k in ("cuda", "cpu"))):
        _close(torch.from_numpy(c), torch.from_numpy(g), 80.0, "TX packets")


# ---- K16 (the Viterbi), K13b and K13f (the decoders' loop forms) -----------

def _viterbi_soft(rng, R, N, g1, g2, k, hard: bool):
    """R frames of N steps: encoded random bits, flipped (hard) or in
    noise (soft), with a few erasures (0.5)."""
    from sdrplusplusbrown_tpu_torch.ops import fec
    out = []
    for _ in range(R):
        c = fec.conv_encode(rng.integers(0, 2, N - (k - 1)), g1, g2,
                            k).astype(np.float32)
        if hard:
            idx = rng.choice(len(c), len(c) // 20, replace=False)
            c[idx] = 1.0 - c[idx]
        else:
            c = np.clip(c + 0.3 * rng.standard_normal(len(c)), 0.0, 1.0)
        c[rng.choice(len(c), len(c) // 16, replace=False)] = 0.5
        out.append(c.astype(np.float32))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("R,N,code", [
    (1, 244, (0b11001, 0b10111, 5)), (1, 148, (0b11001, 0b10111, 5)),
    (1, 54, (0o155, 0o117, 7)), (9, 8168, (0o161, 0o127, 7)),
    (2, 30_000, (0o171, 0o133, 7)), (3, 300, (0o561, 0o753, 9)),
    (1, 330, (0b111, 0b101, 3))],
    ids=["m17_lsf", "m17_stream", "kg_sstv", "ryfi9", "global", "k9",
         "dstar"])
def test_viterbi_kernel_matches_plain(gpu, hard, R, N, code):
    """K16 at M17's LSF and stream lengths, KG-SSTV's frame, nine RyFi
    frames, a frame whose decisions go to global scratch, K = 9 (256
    states: the block form, eight warps) and D-STAR's header (K = 3: the
    warp form at four states): bits and final metrics bit-identical to
    the plain version on the card."""
    from sdrplusplusbrown_tpu_torch.ops import fec
    g1, g2, k = code
    soft = _viterbi_soft(np.random.default_rng(N + hard), R, N, g1, g2, k,
                         hard).to(gpu)
    if N == 30_000:
        assert fec.viterbi_scratch(N, k, R, gpu) is not None
    got = fec.viterbi_rows_kernel(soft, g1, g2, k)
    want = fec.viterbi_rows_ref(soft, g1, g2, k)
    torch.cuda.synchronize()
    _exact(got, want, f"K16 {N}")


def test_costas_nearest_kernel_matches_plain(gpu):
    """K13b at Meteor's 0.1 s block (15 000 samples at 150 kS/s) and a
    partial tile, from a carried phase: bit-identical to the plain loop
    on the card."""
    from sdrplusplusbrown_tpu_torch.models.meteor import (
        BROKEN_PHASES, broken_modulation_error)
    from sdrplusplusbrown_tpu_torch.ops import costas
    blk = costas.Costas(4, 0.005, error_fn=broken_modulation_error)
    for R, T in ((1, 15_000), (3, 2049)):
        rng = np.random.default_rng(T)
        ph = np.asarray(BROKEN_PHASES)[rng.integers(0, 4, (R, T // 2 + 1))]
        noise = rng.standard_normal((R, T)) \
            + 1j * rng.standard_normal((R, T))
        x = np.repeat(np.exp(1j * ph), 2, axis=1)[:, :T] \
            * np.exp(0.002j * np.arange(T)) + 0.05 * noise
        x = torch.from_numpy(x.astype(np.complex64)).to(gpu)
        p0 = torch.from_numpy(rng.uniform(-3, 3, R).astype(np.float32)
                              ).to(gpu)
        f0 = torch.full((R,), 0.001, dtype=torch.float32, device=gpu)
        got = costas.costas_nearest_rows_kernel(blk, x, p0, f0)
        want = costas.costas_nearest_rows_ref(blk, x, p0, f0)
        torch.cuda.synchronize()
        _exact(got, want, f"K13b {R}x{T}")


def test_fd_kernel_matches_plain(gpu):
    """K13f at 20 000 samples (10 a symbol) and rows of 2 500 from a
    carried state mid-stream: symbols, valid, tail, state and offset
    bit-identical to the plain loop on the card."""
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery as cr
    blk = cr.FDClockRecovery(10.0)
    for R, T in ((1, 20_000), (3, 2500)):
        rng = np.random.default_rng(T + R)
        t = np.arange(T) / blk.omega
        sym = np.sign(rng.standard_normal((R, int(t[-1]) + 2)))
        x = np.stack([np.convolve(s[t.astype(int)], np.ones(7) / 7, "same")
                      for s in sym]) + 0.05 * rng.standard_normal((R, T))
        x = torch.from_numpy(x.astype(np.float32)).to(gpu)
        st = _to(blk.init_state((R,)), gpu)
        st["offset"] = torch.full((R,), -3, dtype=torch.int32, device=gpu)
        st["phase"] = torch.full((R,), 0.995, dtype=torch.float32,
                                 device=gpu)
        st["tail"] = torch.from_numpy(rng.standard_normal((R, blk.K - 1))
                                      .astype(np.float32)).to(gpu)
        got = cr.fd_rows_kernel(blk, x, st)
        want = cr.fd_rows_ref(blk, x, st)
        torch.cuda.synchronize()
        assert got[0][1].sum() > T // 12
        _exact(got, want, f"K13f {R}x{T}")


def test_decoder_kernels_raise_instead_of_falling_back(gpu):
    """A CUDA tensor runs K16, K13b and K13f or raises: a mistyped input
    is refused, and a Costas detector other than the nearest-phase one
    still has no kernel form."""
    from sdrplusplusbrown_tpu_torch.models.meteor import \
        broken_modulation_error
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery, costas, fec
    x = torch.ones(1, 16, dtype=torch.complex64, device=gpu)
    z = torch.zeros(1, dtype=torch.float32, device=gpu)
    with pytest.raises(ValueError):
        fec.viterbi_rows(torch.ones(1, 31, device=gpu))
    with pytest.raises(ValueError):
        costas.costas_rows(costas.Costas(
            4, 0.01, error_fn=broken_modulation_error), x.real.contiguous(),
            z, z)
    with pytest.raises(NotImplementedError):
        costas.costas_rows(costas.Costas(
            4, 0.01, error_fn=lambda v: v.imag), x, z, z)
    fd = clock_recovery.FDClockRecovery(10.0)
    with pytest.raises(ValueError):
        clock_recovery.fd_rows(fd, x, _to(fd.init_state((1,)), gpu))
    # the kernel's interpolator takes 8 taps: another count is refused
    x = torch.ones(1, 64, dtype=torch.float32, device=gpu)
    for blk, fn in ((clock_recovery.FDClockRecovery(
            10.0, interp_tap_count=4), clock_recovery.fd_rows),
                    (clock_recovery.MMClockRecovery(
                        4.21, interp_tap_count=4, complex_data=False),
                     clock_recovery.mm_rows)):
        with pytest.raises(ValueError, match="8 interpolator taps"):
            fn(blk, x, _to(blk.init_state((1,)), gpu))


@pytest.mark.parametrize("form", ["viterbi", "nearest", "fd"])
def test_decoder_kernels_chain_clock(gpu, form):
    """With ``clk`` K16 (its trellis and its traceback apart), K13b and
    K13f fill every row's chain cycles and nanoseconds and return the
    same bits as without it."""
    from sdrplusplusbrown_tpu_torch.models.meteor import \
        broken_modulation_error
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery, costas, fec
    R, T = 2, 1000
    rng = np.random.default_rng(8)
    if form == "viterbi":
        fn, args = fec.viterbi_rows_kernel, (_viterbi_soft(
            rng, R, T, fec.G1, fec.G2, 7, False).to(gpu), fec.G1, fec.G2, 7)
    elif form == "nearest":
        z = torch.zeros(R, dtype=torch.float32, device=gpu)
        fn, args = costas.costas_nearest_rows_kernel, (
            costas.Costas(4, 0.01, error_fn=broken_modulation_error),
            _loop_input(rng, R, T).to(gpu), z, z)
    else:
        blk = clock_recovery.FDClockRecovery(4.21)
        fn, args = clock_recovery.fd_rows_kernel, (
            blk, _loop_input(rng, R, T).real.contiguous().to(gpu),
            _to(blk.init_state((R,)), gpu))
    # K16 clocks its trellis and its traceback apart: two pairs a row
    slots = 2 if form == "viterbi" else 1
    clk = torch.zeros(R, 2 * slots, dtype=torch.int64, device=gpu)
    got, want = fn(*args, clk), fn(*args)
    torch.cuda.synchronize()
    _exact(got, want, f"{form} with its chain clock")
    for q in range(slots):
        cycles = clk[:, 2 * q].cpu().numpy()
        ns = clk[:, 2 * q + 1].cpu().numpy()
        assert (cycles >= T // 5).all() and (ns > 0).all(), clk
    assert (cycles / ns < 2.5).all(), clk


# ---- K13's Costas and M&M forms as redesigned: every length, rows, ------
# carried state and samples a symbol; the rotor on every float32 ---------

LOOP_LENGTHS = [1, 4095, 4096, 4097, 72_000]


def _costas_block(form):
    from sdrplusplusbrown_tpu_torch.models.meteor import \
        broken_modulation_error
    from sdrplusplusbrown_tpu_torch.ops import costas
    if form == "nearest":
        return costas.Costas(4, 0.005, error_fn=broken_modulation_error)
    return costas.Costas(form, 0.01, init_freq=0.3, min_freq=0.25,
                         max_freq=0.35)


def _costas_replay(blk, x, ph0, fr0, got):
    """The plain loop's operations (``costas_rows_ref``) replayed on the
    kernel's outputs: each step's error from its output (on the card, all
    steps at once), the loop's phase before each step from them (on the
    host, step by step, each float32 operation rounded as ``loop_update``
    rounds it), then each output from the input and torch.cos / torch.sin
    of its step's phase (on the card, all at once).  Every output and the
    final state bit for bit: by induction on the steps, the plain loop's
    result, at the cost of one pass of vector operations instead of one of
    ~50 torch launches a step."""
    from sdrplusplusbrown_tpu_torch.ops import costas, pll
    y, ph1, fr1 = got
    a, b, lo, hi = (np.float32(v) for v in pll.loop_coefs(blk))
    if blk.error_fn is None:
        err = costas.costas_error(blk.order, y.real, y.imag)
    else:
        err = torch.clamp(blk.error_fn(y), -1.0, 1.0)
    err = err.cpu().numpy()
    R, T = y.shape
    PI, TWO_PI = np.float32(pll.PI), np.float32(pll.TWO_PI)
    ph = np.empty((R, T), np.float32)
    p, f = ph0.cpu().numpy().copy(), fr0.cpu().numpy().copy()
    for t in range(T):
        ph[:, t] = p
        e = err[:, t]
        f = np.minimum(np.maximum(f + b * e, lo), hi)
        d = (p + f) + a * e
        d = np.where(d > PI, d - TWO_PI, d)
        p = np.where(d <= -PI, d + TWO_PI, d).astype(np.float32)
    phs = torch.from_numpy(ph).to(y.device)
    c, s = torch.cos(-phs), torch.sin(-phs)
    want = torch.complex(x.real * c - x.imag * s, x.real * s + x.imag * c)
    assert torch.equal(torch.view_as_real(y).view(torch.int32),
                       torch.view_as_real(want).view(torch.int32))
    assert np.array_equal(ph1.cpu().numpy().view(np.int32),
                          p.view(np.int32))
    assert np.array_equal(fr1.cpu().numpy().view(np.int32),
                          f.astype(np.float32).view(np.int32))


def _costas_check(blk, x, ph0, fr0, what):
    """K13c / K13b against the plain loop on the card (short rows), or
    its replay (``_costas_replay``)."""
    from sdrplusplusbrown_tpu_torch.ops import costas
    nearest = costas.nearest_form(blk)
    kern = costas.costas_nearest_rows_kernel if nearest \
        else costas.costas_rows_kernel
    got = kern(blk, x, ph0, fr0)
    torch.cuda.synchronize()
    if x.shape[1] <= 300:
        ref = costas.costas_nearest_rows_ref if nearest \
            else costas.costas_rows_ref
        _exact(got, ref(blk, x, ph0, fr0), what)
    else:
        _costas_replay(blk, x, ph0, fr0, got)


@pytest.mark.parametrize("T", LOOP_LENGTHS)
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("form", [2, 4, 8, "nearest"])
def test_costas_forms_at_every_length(gpu, form, R, T):
    """K13c (orders 2, 4, 8) and K13b at one sample, either side of 4 096
    and RyFi's 72 000, one row and four, from carried phases across
    [-pi, pi]: outputs and state bit-identical to the plain loop's
    operations (the loop itself where T = 1)."""
    blk = _costas_block(form)
    rng = np.random.default_rng(R * T + len(str(form)))
    x = _loop_input(rng, R, T, w0=0.3).to(gpu)
    ph0 = torch.from_numpy(rng.uniform(-np.pi, np.pi, R).astype(np.float32)
                           ).to(gpu)
    fr0 = torch.full((R,), 0.3 if form != "nearest" else 0.001,
                     dtype=torch.float32, device=gpu)
    _costas_check(blk, x, ph0, fr0, f"costas {form} {R}x{T}")


@pytest.mark.parametrize("T", [300, 4097])
@pytest.mark.parametrize("form", [2, 4, 8, "nearest"])
def test_costas_carried_phase_outside_the_rotor_domain(gpu, form, T):
    """A carried phase outside [-pi, pi] (just past pi, -7.5, 40, 1e5),
    where the first steps take the library's cosf/sinf until the wrap
    brings the phase in, and loop limits too wide to keep it there (the
    checked walk throughout): bit-identical."""
    from sdrplusplusbrown_tpu_torch.ops import costas
    rng = np.random.default_rng(T + len(str(form)))
    x = _loop_input(rng, 4, T, w0=0.3).to(gpu)
    ph0 = torch.tensor([3.1416, -7.5, 40.0, 1e5], dtype=torch.float32,
                       device=gpu)
    fr0 = torch.full((4,), 0.3, dtype=torch.float32, device=gpu)
    _costas_check(_costas_block(form), x, ph0, fr0,
                  f"costas {form} carried phase")
    if form != "nearest":
        wide = costas.Costas(form, 0.01, init_freq=0.3, min_freq=-7.0,
                             max_freq=7.0)
        _costas_check(wide, x, ph0, fr0, f"costas {form} wide limits")


def test_costas_rotor_is_cosf_and_sinf_on_every_float(gpu):
    """The inline rotor and its rotation (csrc/loops.cu:turn, as the
    Costas chain calls it) turning 1 by every float32 in [-float32(pi),
    float32(pi)], about 2.16e9 values in chunks of 2^28, against the plain
    loop's products on torch.cos and torch.sin on the card (the library's
    cosf and sinf): bit for bit, signed zeros included (the sine of -0
    comes out +0 from both, as -0 + 0 does)."""
    from sdrplusplusbrown_tpu_torch.ops import costas
    top = int(np.float32(np.pi).view(np.int32))
    chunk = 1 << 28
    for sign in (0, -(1 << 31)):
        for lo in range(0, top + 1, chunk):
            bits = torch.arange(sign + lo, sign + min(lo + chunk, top + 1),
                                dtype=torch.int32, device=gpu)
            a = bits.view(torch.float32)
            c, s = costas.rotor_kernel(a)
            cr, sr = costas.rotor_ref(a)
            for got, want in ((c, cr), (s, sr)):
                bad = got.contiguous().view(torch.int32) != want.view(
                    torch.int32)
                if bad.any():
                    i = int(bad.nonzero()[0, 0])
                    raise AssertionError(
                        f"{int(bad.sum())} values differ; first: "
                        f"{float(a[i])!r} -> {float(got[i])!r}, want "
                        f"{float(want[i])!r}")
            del bits, a, c, s, cr, sr, bad
    torch.cuda.synchronize()


def _mm_input(rng, R, T, sps, cplx):
    """R rows of +-1 symbols at ``sps`` samples a symbol, band-limited by
    a 3-tap average, in noise (complex: a quadrature stream too)."""
    t = np.arange(T) / sps
    sym = np.sign(rng.standard_normal((R, int(t[-1]) + 2)))
    x = np.stack([np.convolve(s[t.astype(int)], np.ones(3) / 3, "same")
                  for s in sym]) + 0.05 * rng.standard_normal((R, T))
    if cplx:
        q = np.sign(rng.standard_normal((R, int(t[-1]) + 2)))
        x = x + 1j * np.stack([np.convolve(s[t.astype(int)],
                                           np.ones(3) / 3, "same")
                               for s in q])
    return torch.from_numpy(x).to(torch.complex64 if cplx
                                  else torch.float32)


def _mm_check(form, sps, R, T, gpu, seed, phase=None, offset=None, P=128):
    """K13m (real, complex) or K13f with a bank of P rows on R rows of T
    samples from a carried state (the given phase and offset, else 0.37
    and -2, a random tail and history): symbols, valid, the new tail,
    state and offset bit for bit the plain version's on a host CPU copy of
    the call (its adds, multiplies, compares, floors and gathers round the
    same on either device)."""
    from sdrplusplusbrown_tpu_torch.ops import clock_recovery as cr
    cplx = form == "mm_cplx"
    blk = cr.FDClockRecovery(sps, interp_phase_count=P) if form == "fd" \
        else cr.MMClockRecovery(sps, 1e-6, 0.01, 0.01,
                                interp_phase_count=P, complex_data=cplx)
    rng = np.random.default_rng(seed)
    x = _mm_input(rng, R, T, sps, cplx)
    st = blk.init_state((R,))
    st["offset"] = torch.full((R,), -2, dtype=torch.int32) \
        if offset is None else torch.tensor(offset, dtype=torch.int32)
    st["phase"] = torch.full((R,), 0.37, dtype=torch.float32) \
        if phase is None else torch.tensor(phase, dtype=torch.float32)
    dt = torch.complex64 if cplx else torch.float32
    st["tail"] = torch.from_numpy(rng.standard_normal(
        (R, blk.K - 1)).astype(np.float32)).to(dt)
    if cplx:
        for k in ("p0", "p1", "c0"):
            st[k] = torch.from_numpy((rng.standard_normal(R) + 1j
                                      * rng.standard_normal(R))
                                     .astype(np.complex64))
    elif form == "mm_real":
        st["last_out"] = torch.from_numpy(
            rng.standard_normal(R).astype(np.float32))
    kern = cr.fd_rows_kernel if form == "fd" else cr.mm_rows_kernel
    ref = cr.fd_rows_ref if form == "fd" else cr.mm_rows_ref
    got = kern(blk, x.to(gpu), _to(st, gpu))
    torch.cuda.synchronize()
    want = ref(blk, x, st)
    got = ((got[0][0].cpu(), got[0][1].cpu()),
           {k: v.cpu() for k, v in got[1].items()})
    _exact(got, want, f"{form} sps {sps} {R}x{T}")
    return want


@pytest.mark.parametrize("T", LOOP_LENGTHS)
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("form", ["mm_real", "mm_cplx", "fd"])
def test_clock_forms_at_every_length(gpu, form, R, T):
    """K13m real and complex and K13f at RDS's 4.2 samples a symbol (FD
    at 10, its decoders'), at one sample, either side of 4 096 (the ring's
    chunk is 1 024 and it holds four) and 72 000, one row and four:
    bit-identical to the plain version."""
    sps = 10.0 if form == "fd" else 4.21
    want = _mm_check(form, sps, R, T, gpu, seed=R * T + len(form))
    if T > 100:
        assert want[0][1].sum() > R * T // (2 * sps)


@pytest.mark.parametrize("sps", [1.68, 2.08, 3.0, 4.2])
@pytest.mark.parametrize("form", ["mm_real", "mm_cplx", "fd"])
def test_clock_forms_at_every_symbol_rate(gpu, form, sps):
    """Falcon9's 1.68, Meteor's 2.08, RyFi's 3.0 and RDS's 4.2 samples a
    symbol (the window's step and so the runs' bound differ) over 20 000
    samples, two rows: bit-identical."""
    _mm_check(form, sps, 2, 20_000, gpu, seed=int(sps * 100))


@pytest.mark.parametrize("P", [16, 256])
@pytest.mark.parametrize("form", ["mm_real", "mm_cplx", "fd"])
def test_clock_forms_at_any_power_of_two_bank(gpu, form, P):
    """A bank of 16 or 256 rows in place of every caller's 128 (a run
    takes the row from the phase by a mask of P - 1) over 20 000 samples,
    two rows: bit-identical."""
    _mm_check(form, 3.0, 2, 20_000, gpu, seed=P, P=P)


@pytest.mark.parametrize("form", ["mm_real", "mm_cplx", "fd"])
def test_clock_forms_from_any_carried_state(gpu, form):
    """Carried phases outside [0, 1) (-0.4, 1.7) and at its ends, offsets
    before the block (-9), inside it (5) and past it (T + 3: every step
    invalid): bit-identical, the steps a run cannot take included."""
    T = 4097
    _mm_check(form, 3.0, 4, T, gpu, seed=11,
              phase=[-0.4, 1.7, 0.0, 0.99999994],
              offset=[-9, 5, T + 3, 0])
