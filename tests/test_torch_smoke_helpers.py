"""chip_smoke.py's host-side helpers, which need no GPU: the work counts
behind each kernel's bound, and the profiler's kernel-name shortening."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from sdrplusplusbrown_tpu_torch.models.rx_vfo import ChannelizedRxVFOBank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("odt, nbytes", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_k5_bound_counts_an_fft_and_is_bound_by_bytes(smoke, odt, nbytes):
    """scanner128's K5: 240 000 input samples, M = 48, 288 taps; the DFT
    counts 5·M·log2 M flops per frame, so the bytes bound it."""
    bank = ChannelizedRxVFOBank(2.4e6, 50e3, 12.5e3, device="cpu")
    pfb, post = bank.pipes()
    T, M = 240_000, 48
    Tb = 2 * T // M
    W = post.plan(Tb)["Tb_pad"]
    xr = torch.zeros(T)
    args = (pfb, xr, xr, None, None, W, odt, odt)
    b, ops = smoke.work("K5", args)
    assert b == 8 * T + 2 * M * W * nbytes
    assert ops == pytest.approx(Tb * (4 * 288 + 5 * M * np.log2(M)))
    ms, by = smoke.bound("K5", args)
    assert by == "bytes"
    assert ms == pytest.approx(b / smoke.HBM_BPS * 1e3)


def test_short_kernel_names(smoke):
    assert smoke.short_kernel(
        "(anonymous namespace)::fm_audio_kernel(void const*, int)") \
        == "fm_audio_kernel"
    assert smoke.short_kernel(
        "void at::native::vectorized_elementwise_kernel<8, "
        "at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)"
        ">(int)") == "vectorized_elementwise_kernel"
    assert smoke.short_kernel("Memcpy DtoD (Device -> Device)") \
        == "Memcpy DtoD"


@pytest.mark.parametrize("cplx,rows,I,D,kw", [(True, 1, 1, 4, 304),
                                              (False, 8, 48, 125, 368)])
def test_app_stage_names_each_k8_geometry(smoke, cplx, rows, I, D, kw):
    """Phase 10 holds every distinct K8 geometry against its plain
    version: the name tells dtype, rows, I/D and kernel width apart."""
    dt = torch.complex64 if cplx else torch.float32
    shape = (1000,) if rows == 1 else (rows, 1000)
    call = (torch.zeros(shape, dtype=dt), torch.zeros(shape[:-1] + (7,),
                                                      dtype=dt),
            torch.zeros(I, kw), I, D)
    assert smoke.app_stage(call) == (
        f"{'complex' if cplx else 'real'} rows {rows} I/D {I}/{D} kw {kw}")


@pytest.mark.parametrize("odt, nbytes", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_k5c_bound_is_bound_by_bytes(smoke, odt, nbytes):
    """channelizer64's K5c: 2^21 input samples, M = 64, tpp = 19, one
    frame per M samples (hop M): 16.8 MB in, the bins out."""
    ch, _ = smoke.channelizer64("cpu", smoke.CHZ_T)
    pipe = ch.pfb()
    T, M = smoke.CHZ_T, smoke.CHZ_M
    xr = torch.zeros(T)
    args = (pipe, xr, xr, None, None, T // M, odt, odt)
    b, ops = smoke.work("K5c", args)
    assert b == 8 * T + 2 * M * (T // M) * nbytes
    assert ops == pytest.approx(T // M * (4 * 19 * M + 5 * M * np.log2(M)))
    assert smoke.bound("K5c", args)[1] == "bytes"


def test_k4r_work_counts_every_row(smoke):
    """K4r on [64, 32, 1024] bf16 views: each frame's planes in, its float32
    dB out, 5·N·log2 N flops of FFT and 4·N of power and log."""
    v = torch.zeros((64, 32, 1024), dtype=torch.bfloat16)
    b, ops = smoke.work("K4r", (v, v, 1024, -300.0))
    assert b == 2048 * 1024 * (2 * 2 + 4)
    assert ops == 2048 * (5 * 1024 * 10 + 4 * 1024)


def test_channelizer64_tone_oracle_on_the_cpu(smoke):
    """Phase 17's oracle on the port's plain path at a short block (two
    spectrum frames a channel): every tone found at its bin in its own
    channel; a spectrum with one channel's tone moved raises."""
    T = 131_072
    ch, step = smoke.channelizer64("cpu", T)
    xr, xi = smoke.chz_wideband(T, ch.channel_freqs())
    spec, st = step(ch.init_state(), (torch.from_numpy(xr),
                                      torch.from_numpy(xi)))
    assert spec.shape == (64, 2, 1024)
    assert "8 tones each at bin 131" in smoke.chz_tone_oracle(spec)
    bad = spec.clone()
    bad[smoke.CHZ_TONES[0]] = bad[smoke.CHZ_TONES[0]].roll(40, dims=-1)
    with pytest.raises(RuntimeError, match="tone peaks at bin"):
        smoke.chz_tone_oracle(bad)
    tail = torch.complex(torch.from_numpy(xr[-ch.pfb().n_hist:]),
                         torch.from_numpy(xi[-ch.pfb().n_hist:]))
    assert torch.equal(ch.pfb().state_to_xw(st), tail)


@pytest.mark.parametrize("cplx", [False, True])
def test_k8_work_counts_each_phase_rows_nonzero_band(smoke, cplx):
    """The polyphase tile multiplies each phase row's band (first to last
    nonzero tap), no more: the bound counts the same, an all-zero row
    nothing (csrc/fir_tile.cuh)."""
    kern = torch.zeros(3, 40)
    kern[0, 5:9] = 1.0                  # band 4
    kern[1, 10] = kern[1, 29] = 2.0     # band 20, zeros inside count
    dt = torch.complex64 if cplx else torch.float32
    x, tail = torch.zeros((2, 300), dtype=dt), torch.zeros((2, 39), dtype=dt)
    n_m = (39 + 300 - 40) // 5 + 1
    assert smoke.band_taps(kern) == 24
    _, ops = smoke.work("K8", (x, tail, kern, 3, 5))
    assert ops == 2 * (2 if cplx else 1) * 24 * n_m * 2


def test_k3_work_counts_the_folded_kernels_band(smoke):
    """K3's 48/125 folded kernel: 256-257 nonzero taps a phase row of 493,
    so its bound is ~52 % of the dense count."""
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    from sdrplusplusbrown_tpu_torch.ops import wfm_kernel
    pipe = wfm_kernel.MPXAudioPoly(
        Radio(2.4e6, DEMOD_WFM, device="cpu").demod.audio_poly)
    raw = torch.zeros((16, 12_500))
    _, ops = smoke.work("K3", (pipe, raw, 12_500, None, torch.float32))
    dense = 2 * 16 * 100 * 48 * 493
    band = smoke.band_taps(pipe.taps("cpu", torch.float32))
    assert 48 * 256 <= band <= 48 * 257
    assert ops == 2 * 16 * 100 * band and 0.51 < ops / dense < 0.53


@pytest.mark.parametrize("odt, nbytes", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_k1_work_counts_the_wideband_the_if_and_the_stage_tails(smoke, odt,
                                                                 nbytes):
    """WFM-8's K1: the wideband planes in, the IF planes out, each chained
    stage's complex tail read and its new tail written (8 bytes a sample
    each way); bound by its multiply-adds."""
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    pipe = Radio(2.4e6, DEMOD_WFM, device="cpu")._build_vfo_shared().pipe()
    T, C = 240_000, 8
    xr = torch.zeros(T)
    args = (pipe, xr, xr, None, torch.zeros(C), None, None, odt)
    b, ops = smoke.work("K1", args)
    carry = sum(st["carry"] for st in pipe.stages)
    assert carry == 91 + 252
    assert b == 8 * T + 2 * C * 50_000 * nbytes + 16 * C * carry
    assert ops == (4 * C * 60_000 * 304 + 6 * C * T
                   + 4 * C * 50_000 * (97 + 253))
    assert smoke.bound("K1", args)[1] == "operations"


def test_k2_work_counts_the_carried_state(smoke):
    """WFM-8's K2: the IF planes in, the L/R planes out, the carried IF
    sample, the halfband tails and mpx_hist read and written."""
    from sdrplusplusbrown_tpu_torch.models.radio import Radio, DEMOD_WFM
    pipe = Radio(2.4e6, DEMOD_WFM, device="cpu").demod.pipes()[0]
    C, m_if = 8, 50_000
    iq = torch.zeros((2 * C, m_if), dtype=torch.bfloat16)
    tails = [torch.zeros((C, len(h) - 1)) for h in pipe.hb_taps]
    hist = torch.zeros((C, pipe.K))
    args = (pipe, iq, m_if, None, tails, hist, torch.bfloat16)
    b, _ = smoke.work("K2", args)
    state = 2 * C + C * (25 + 104) + C * 159
    assert [len(h) for h in pipe.hb_taps] == [26, 105] and pipe.K == 159
    assert b == 2 * C * m_if * 2 + 2 * 4 * state + 2 * C * 12_500 * 2


def test_graph_node_kinds_reads_a_dot_dump(smoke):
    """Phase 26 counts a captured call's kernel launches from the graph's
    dot dump: one kind a node definition, edges and kernel names that
    mention a copy not counted as nodes or copies."""
    dot = "\n".join([
        'digraph dot {', 'subgraph cluster_1 {',
        'label="graph_1" graph[style="dashed"];',
        '"graph_1_node_0"[style="solid" shape="record" label="{',
        'KERNEL', '| {ID | 0 | ...}',
        '| {name | void at::native::vectorized_elementwise_kernel<4, '
        'memcpy_like> }"];',
        '"graph_1_node_1"[style="solid" shape="record" label="{MEMSET',
        '| {ID | 1}"];',
        '"graph_1_node_2"[style="solid" shape="record" label="{MEMCPY',
        '| {ID | 2}"];',
        '"graph_1_node_3"[style="solid" shape="record" label="{KERNEL',
        '| {ID | 3}"];',
        '"graph_1_node_0" -> "graph_1_node_1";', '}', '}'])
    assert smoke.graph_node_kinds(dot) == ["kernel", "memset", "memcpy",
                                           "kernel"]
    assert smoke.graph_node_kinds("digraph dot {\n}") == []


def test_net_client_config_is_phase_19s_app_on_a_server(smoke):
    conf = smoke.net_client_config(5259, "int8", "manual")
    want = smoke.served_config("", "manual")
    assert conf["source"] == {"type": "sdrpp_server", "host": "127.0.0.1",
                              "port": 5259, "compression": "int8"}
    assert conf["modules"] == want["modules"] and sorted(conf["modules"]) \
        == ["N", "Q", "W"]
    assert {k: v for k, v in conf.items() if k != "source"} == \
        {k: v for k, v in want.items() if k != "source"}


def test_net_server_process_streams_the_capture(smoke, tmp_path):
    """Phase 26 (b)'s threaded client's server: ``python -m
    sdrplusplusbrown_tpu_torch --server --device cpu`` on a capture, int8
    blocks at its rate, exit code 0 on close."""
    from sdrplusplusbrown_tpu_torch.io.wav import write_wav
    from sdrplusplusbrown_tpu_torch.server.stream_client import StreamClient
    cap = str(tmp_path / "baseband_100000000Hz_10-00-00_01-01-2024.wav")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(48_000) + 1j * rng.standard_normal(48_000))
    write_wav(cap, (0.1 * x).astype(np.complex64), smoke.FS, bits=32)
    srv = smoke.NetServerProcess(str(tmp_path / "srv"), cap)
    try:
        cli = StreamClient("127.0.0.1", srv.port, compression="int8")
        try:
            got = []
            for blk in cli.blocks(timeout=30):
                got.append(blk)
                if len(got) == 3:
                    break
        finally:
            cli.close()
    finally:
        srv.close()
    assert cli.samplerate == smoke.FS
    assert [b.shape for b in got] == [(int(smoke.FS / 200),)] * 3
    assert srv.proc.returncode == 0


def test_phase27_bank_channelizes_every_group(smoke):
    """Phase 27 (b)'s 48 VFOs form three groups of 16 (AM, USB, CW), each
    channelized by "auto"; the wideband carries a carrier on each even
    VFO; a CW VFO's tone is the demod's 800 Hz note."""
    from sdrplusplusbrown_tpu_torch.models import radio_bank as rb
    from sdrplusplusbrown_tpu_torch.models.radio import (DEMOD_AM, DEMOD_CW,
                                                         DEMOD_USB)
    vfos = smoke.modes_vfos()
    bank = rb.RadioBank(smoke.FS, vfos, device="cpu")
    assert bank.channelized == {DEMOD_AM: True, DEMOD_USB: True,
                                DEMOD_CW: True}
    assert [len(g) for g in bank.groups.values()] == [smoke.MODES_C] * 3
    assert smoke.modes_block(smoke.FS, bank.in_multiple) == 243_200
    assert smoke.modes_tone_hz(DEMOD_CW) == 800.0
    assert smoke.modes_tone_hz(DEMOD_AM) == smoke.TONE_HZ
    x = smoke.modes_wideband(48_000, smoke.FS, vfos)
    spec = np.abs(np.fft.fft(x))
    f = np.fft.fftfreq(x.size, 1 / smoke.FS)
    for i, v in enumerate(vfos):
        near = np.abs(f - v.offset_hz) < 1500.0
        assert (spec[near].max() > 100.0) == (i % 2 == 0), v.name


def test_tone_level_and_snr_at_a_chosen_frequency(smoke):
    t = np.arange(4800) / 48_000.0
    row = 0.5 * np.sin(2 * np.pi * 800.0 * t + 0.3)
    assert smoke.tone_level_db(row, 800.0) == pytest.approx(
        20 * np.log10(0.5), abs=1e-6)
    assert smoke.tone_snr_db(row, 800.0) > 200.0
    assert smoke.tone_snr_db(row) < 0.0


def test_own_kernels_names_each_csrc_kernel(smoke):
    """``call_profile`` compares the profiler's events of these kernels
    with the wrappers' counts."""
    own = smoke.own_kernels()
    for name in ("pfb_big_kernel", "pfb_ws_kernel", "post_d2_kernel",
                 "post_fir_kernel", "agc_rows_kernel", "fir_rows_kernel",
                 "fused_mix_kernel", "stage_kernel", "costas_kernel"):
        assert name in own, name
    assert "vectorized_elementwise_kernel" not in own
    assert smoke.wrapper_launches() >= 0


def test_no_plain_on_card_restores_the_plain_versions(smoke):
    """Within the guard a plain version still runs on CPU tensors; after
    it the module attributes are the originals again."""
    from sdrplusplusbrown_tpu_torch.ops import agc, fir_kernel
    orig = (fir_kernel.fir_rows_ref, agc.agc_rows_ref)
    with smoke.no_plain_on_card():
        assert fir_kernel.fir_rows_ref is not orig[0]
        y, _ = fir_kernel.fir_rows(torch.ones(2, 8), torch.zeros(2, 2),
                                   torch.ones(1, 3), 1, 1)
        assert y.shape == (2, 8)
    assert (fir_kernel.fir_rows_ref, agc.agc_rows_ref) == orig


@pytest.mark.parametrize("odt, nbytes", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_k5_bound_counts_the_gathered_rows_and_valid_frames(smoke, odt,
                                                            nbytes):
    """The channelized CW group's K5 (M = 800, tpp 5) on its 32 gathered
    rows: 2·T planes in, 32 rows of the T/h valid frames out (the large-M
    kernel writes no more), the fold's 4·K0 operations a frame and the
    DFT counted as the cheaper of an FFT and 32 direct rows."""
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_CW, Radio
    bank = Radio(2.4e6, DEMOD_CW, device="cpu")._build_vfo_channelized()
    pfb, post = bank.pipes()
    T, M = 243_200, pfb.M
    Tb = 2 * T // M
    W = post.plan(Tb)["Tb_pad"]
    xr = torch.zeros(T)
    rows = torch.zeros(32, dtype=torch.int32)
    args = (pfb, xr, xr, None, None, W, odt, odt, rows)
    b, ops = smoke.work("K5", args)
    assert W > Tb and b == 8 * T + 32 * Tb * nbytes
    dft = min(5 * M * np.log2(M), 4 * M * 32)
    assert ops == pytest.approx(Tb * (4 * pfb.K0 + dft))
    assert smoke.bound("K5", args)[1] == "bytes"


def test_torch_calls_counts_a_modules_torch_calls(smoke):
    """Phase 27 (b)'s guard on K5's input: inside ``torch_calls`` the
    plain K5's ``torch.cat`` calls are counted; after it the module's
    ``torch`` is torch again."""
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_AM, Radio
    from sdrplusplusbrown_tpu_torch.ops import channelizer_kernel as ck
    pfb, _ = Radio(2.4e6, DEMOD_AM, device="cpu")._build_vfo_channelized() \
        .pipes()
    z = torch.zeros(pfb.M * 4)
    h = torch.zeros(pfb.n_hist)
    with smoke.torch_calls(ck, ("cat", "zeros")) as tc:
        ck.pfb_bins_ref(pfb, z, z, h, h, 8, torch.float32, torch.float32)
    assert tc.counts["cat"] >= 2 and tc.counts["zeros"] >= 2
    assert ck.torch is torch


def test_k14_bound_counts_the_frames_state_and_ring_slots(smoke):
    """The served IF NR's K14 (nFFT 96 000, five frames a block): the
    frames in and the gains out, four state rows in and three out, the F
    ring slots of both rings read and written, 62 operations a bin and
    frame; bound by its bytes."""
    from sdrplusplusbrown_tpu_torch.ops.logmmse import LogMMSE
    core = LogMMSE(2.4e6, wideband=True)
    st = core.init_state(())
    sig = torch.zeros(5, core.nFFT)
    b, ops = smoke.work("K14", (core, st, sig, None))
    N = core.nFFT
    assert b == 4 * N * (2 * 5 + 4 * 5 + 7) + 2 * (1 + 8)
    assert ops == 62 * N * 5
    assert smoke.bound("K14", (core, st, sig, None))[1] == "bytes"


@pytest.mark.parametrize("cplx, per_sample", [(True, False), (False, True)])
def test_k15_bound_counts_b_y_and_a_pole_a_sample(smoke, cplx, per_sample):
    """K15 at the front end's DC blocker (complex rows, one pole) and the
    noise blanker's envelope (real rows, a pole a sample): b and y0 in, y
    out, a float32 a where it is a tensor; a multiply-add a sample on
    each part."""
    T = 120_000
    b = torch.zeros(1, T, dtype=torch.complex64 if cplx else torch.float32)
    a = torch.zeros(1, T) if per_sample else 0.99
    y0 = torch.zeros(1, dtype=b.dtype)
    nb, ops = smoke.work("K15", (a, b, y0))
    e = 8 if cplx else 4
    assert nb == 2 * T * e + e + (4 * T if per_sample else 0)
    assert ops == 2 * (2 if cplx else 1) * T
    assert smoke.bound("K15", (a, b, y0))[1] == "bytes"
