"""The serving path's units on the CPU, each against the JAX package's on
the same input:

  * ``IQFrontEnd(dc_blocking=True)``: baseband, spectra and the DC
    blocker's complex state ``st["dc"]`` >= 80 dB over three blocks, at
    decimation 1 (the app's) and 4;
  * ``migrate_state`` on the same state trees (a growing and a shrinking
    tail, an unchanged leaf, a new leaf, a scalar, the refused kinds);
  * ``calculate_vfo_signal_info`` on the same dB lines;
  * ``Rechunker``, ``RealTimeGuard``, ``Merger``/``Splitter`` and
    ``SinkStream``/``StreamRegistry`` fed the sequences of
    tests/test_io_pump.py and tests/test_sink_layer.py: equal outputs;
  * ``write_wav`` / ``WavRecorder`` files byte-identical, ``read_wav_iq``
    and ``FileSource.blocks()`` equal, ``ConfigManager`` load, defaults
    and autosave equal on disk, and the metrics;
  * the port's ``StreamPump`` against the front end and bank it wires,
    called by hand, and against the JAX package's ``StreamPump``.

Each scenario runs twice, once on the JAX package's module and once on
the port's, and the two results must be equal."""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import sdrplusplusbrown_tpu.io.file_source as jax_file_source
import sdrplusplusbrown_tpu.io.recorder as jax_recorder
import sdrplusplusbrown_tpu.io.wav as jax_wav
import sdrplusplusbrown_tpu.runtime.pump as jax_pump
import sdrplusplusbrown_tpu.runtime.routing as jax_routing
import sdrplusplusbrown_tpu.runtime.sink as jax_sink
import sdrplusplusbrown_tpu.utils.config as jax_config
import sdrplusplusbrown_tpu.utils.metrics as jax_metrics
from sdrplusplusbrown_tpu.models import radio_bank as jax_bank
from sdrplusplusbrown_tpu.models.iq_frontend import IQFrontEnd as JaxFrontEnd
from sdrplusplusbrown_tpu.models.waterfall import Waterfall as JaxWaterfall
from sdrplusplusbrown_tpu.ops.spectrum import (
    calculate_vfo_signal_info as jax_vfo_info)
from sdrplusplusbrown_tpu.runtime.migrate import (
    migrate_state as jax_migrate)
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.io import file_source, recorder, wav
from sdrplusplusbrown_tpu_torch.models.iq_frontend import IQFrontEnd
from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_NFM
from sdrplusplusbrown_tpu_torch.models.radio_bank import RadioBank, VFOSpec
from sdrplusplusbrown_tpu_torch.models.waterfall import Waterfall
from sdrplusplusbrown_tpu_torch.ops.spectrum import calculate_vfo_signal_info
from sdrplusplusbrown_tpu_torch.runtime import pump, routing, sink
from sdrplusplusbrown_tpu_torch.runtime.migrate import migrate_state
from sdrplusplusbrown_tpu_torch.utils import config, metrics
from sdrplusplusbrown_tpu_torch.utils.event import Event
from sdrplusplusbrown_tpu_torch.utils.flog import flog

from torch_parity import (FS, assert_spectra_close, assert_state_close,
                          port_f32_handoff, snr_db, wfm_iq)  # noqa: F401


# ---------------------------------------------------------------------
# the front end's DC blocker

@pytest.mark.parametrize("decim", [1, 4])
def test_frontend_dc_blocker_matches_jax(decim):
    jf = JaxFrontEnd(FS, decim_ratio=decim, dc_blocking=True)
    pf = IQFrontEnd(FS, decim_ratio=decim, dc_blocking=True, device="cpu")
    assert pf.in_multiple == jf.in_multiple
    assert pf.dc.rate == jf.dc.rate == 50.0 / (FS / decim)
    T = 2 * pf.in_multiple if decim == 1 else pf.in_multiple
    x = wfm_iq(3 * T, np.linspace(-0.2e6, 0.25e6, 3), seed=decim + 10)
    x = (x + (0.1 - 0.07j)).astype(np.complex64)
    js, ps = jf.init_state(), pf.init_state()
    assert ps["dc"].dtype == torch.complex64 and ps["dc"].shape == ()
    for b in range(3):
        xb = x[b * T:(b + 1) * T]
        (jb, jspec), js = jf.apply(None, js, jnp.asarray(xb))
        (pb, pspec), ps = pf.apply(None, ps, torch.from_numpy(xb))
        assert pb.shape == (T // decim,) and pb.dtype == torch.complex64
        assert snr_db(np.asarray(jb), pb.numpy()) >= 80.0, b
        assert_spectra_close(np.asarray(jspec), pspec.numpy())
        assert_state_close(js, ps, 80.0)
    # the blocker follows the offset: the running mean is near it and the
    # baseband's mean is far below it
    assert abs(complex(ps["dc"]) - (0.1 - 0.07j)) < 0.05
    assert abs(complex(pb.mean())) < 0.01


# ---------------------------------------------------------------------
# migrate_state on the same trees

def _f(*a):
    return np.asarray(a, np.float32)


MIGRATE_CASES = {
    "grow tail": ({"t": np.arange(3, dtype=np.float32)},
                  {"t": np.ones(5, np.float32)}),
    "shrink tail": ({"t": np.arange(6, dtype=np.complex64)},
                    {"t": np.zeros(4, np.complex64)}),
    "unchanged and new": ({"a": _f(1, 2, 3, 4), "gone": _f(9)},
                          {"a": np.zeros(4, np.float32), "new": _f(5, 6)}),
    "nested lists, leading dims": (
        {"vfo": {"decim": [np.arange(8, dtype=np.float32).reshape(2, 4),
                           _f(7, 8)]},
         "demod": {"phase": np.float32(1.25)}},
        {"vfo": {"decim": [np.zeros((3, 4), np.float32),
                           np.zeros(5, np.float32)]},
         "demod": {"phase": np.float32(0.0), "extra": _f(1)}}),
    "refused kinds": ({"c2r": np.ones(4, np.complex64),
                       "r2c": _f(1, 2, 3),
                       "int2f": np.arange(3, dtype=np.int32),
                       "rank": np.zeros((2, 3), np.float32)},
                      {"c2r": _f(0, 0, 0, 0),
                       "r2c": np.zeros(3, np.complex64),
                       "int2f": np.zeros(3, np.float32),
                       "rank": np.ones(3, np.float32)}),
}


@pytest.mark.parametrize("case", sorted(MIGRATE_CASES))
def test_migrate_state_matches_jax(case):
    old, tpl = MIGRATE_CASES[case]
    want = jax_migrate(jax_tree(old), jax_tree(tpl))
    got = migrate_state(convert.state_from_jax(old, device="cpu"),
                        convert.state_from_jax(tpl, device="cpu"))
    assert_state_close(want, got, 400.0)        # leaf for leaf, exactly
    assert migrate_state(None, got) is got


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree)


def test_migrate_state_carries_a_radio_through_a_bandwidth_change():
    """A WFM radio rebuilt at another bandwidth keeps its tails (aligned
    right) and NCO, as the JAX rule does on the same states."""
    from sdrplusplusbrown_tpu.models.radio import Radio as JaxRadio
    from sdrplusplusbrown_tpu_torch.models.radio import DEMOD_WFM, Radio
    jr = JaxRadio(FS, DEMOD_WFM, bandwidth=150e3)
    x = wfm_iq(24_000, [2e5], seed=3)
    _, js = jr.apply(jr.make_params(2e5), jr.init_state(), jnp.asarray(x))
    tpl = JaxRadio(FS, DEMOD_WFM, bandwidth=120e3).init_state()
    ptpl = Radio(FS, DEMOD_WFM, bandwidth=120e3, device="cpu").init_state()
    assert_state_close(tpl, ptpl, 400.0)
    want = jax_migrate(js, tpl)
    got = migrate_state(convert.state_from_jax(js, device="cpu"), ptpl)
    assert_state_close(want, got, 400.0)


# ---------------------------------------------------------------------
# the per-VFO SNR estimate and the waterfall

@pytest.mark.parametrize("offset,bw", [(3e5, 12.5e3), (-1.1e6, 150e3),
                                       (0.0, 2.0e3), (1.19e6, 50e3),
                                       (-1.2e6, 10e3)])
def test_vfo_signal_info_matches_jax(offset, bw):
    rng = np.random.default_rng(4)
    line = (-90 + 3 * rng.standard_normal(4096)).astype(np.float32)
    line[int((3e5 / FS + 0.5) * 4096) + np.arange(-2, 3)] = -20.0
    want = jax_vfo_info(line, offset, bw, FS)
    got = calculate_vfo_signal_info(line, offset, bw, FS)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def test_waterfall_matches_jax():
    rng = np.random.default_rng(6)
    jw, pw = JaxWaterfall(256, history=8), Waterfall(256, history=8)
    for _ in range(11):
        ln = rng.standard_normal(256).astype(np.float32)
        jw.push_fft(ln)
        pw.push_fft(ln)
    np.testing.assert_array_equal(jw.lines(20), pw.lines(20))
    np.testing.assert_array_equal(jw.zoom(1e5, 4e5, FS, 32),
                                  pw.zoom(1e5, 4e5, FS, 32))
    assert jw.vfo_signal_info(0.0, 1e5, FS) == pw.vfo_signal_info(0.0, 1e5,
                                                                  FS)


# ---------------------------------------------------------------------
# pump, routing and sink layer: one scenario, both packages

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def rechunker_scenario(m):
    rc = m.Rechunker(100)
    return [[len(o) for o in rc.push(np.arange(n, dtype=np.complex64))]
            for n in (250, 50, 99, 1, 300)]


def guard_scenario(m):
    g = m.RealTimeGuard(threshold=0.95, strikes_needed=2, window=4)
    out = []
    for el in (0.5, 0.96, 1.2, 1.2, 0.1, 0.1, 2.0, 1.5, 0.1):
        out.append((g.report(el, 1.0), g.rt_factor, g.seconds_behind))
        if el == 0.1:
            g.reset_policy()
    return out


def merger_scenario(m):
    clk = FakeClock()
    mg = m.Merger(time_fn=clk)
    rx, tx = mg.bind(100), mg.bind(0)
    out = []
    mg.push(rx, np.full(512, 1.0))
    out.append(mg.pull())
    clk.t += 200.0
    mg.push(rx, np.full(512, 1.0))
    mg.push(tx, np.full(256, 2.0))
    out += [mg.pull(), mg.pull()]
    clk.t += 50.0
    mg.push(rx, np.full(128, 1.0))
    out.append(mg.pull())
    clk.t += 200.0
    mg.push(rx, np.arange(3000, dtype=np.float32))
    out += mg.drain()
    sp, got = m.Splitter(), []
    cb = got.append
    sp.bind(cb)
    sp.bind(lambda b: got.append(-b))
    sp.push(np.ones(3))
    sp.unbind(cb)
    sp.push(np.ones(2))
    return out + got


def sink_scenario(m):
    clk = FakeClock()
    s = m.SinkStream("Radio", 48000.0, time_fn=clk)
    got = []
    s.bind(got.append)
    s.volume = 0.5
    out = [s.push_demod(np.ones((2, 100), np.float32))]
    clk.t += 200.0
    port = s.inject(m.PRIO_TX_INJECT)
    s.volume = 1.0
    out.append(s.push(port, np.full((2, 64), 3.0, np.float32)))
    clk.t += 200.0
    s.muted = True
    out.append(s.push_demod(np.ones((2, 50), np.float32)))
    reg = m.StreamRegistry(time_fn=clk)
    base = reg.register("Radio", 48000.0)
    added, hooks = [], []
    reg.on_add_substream.bind(added.append)
    reg.on_stream_data.bind(hooks.append)
    subs = [reg.add_substream("Radio"), reg.add_substream("Radio"),
            reg.add_substream("Radio__##1")]
    sub_got = []
    subs[0].bind(sub_got.append)
    clk.t += 500.0
    base.push_demod(np.full((2, 10), 0.25, np.float32))
    reg.publish(m.StreamHook(source="Radio",
                             source_type=m.StreamHook.SOURCE_DEMOD_OUTPUT,
                             priority=m.PRIO_DEMOD, samplerate=48000.0,
                             stereo_data=np.zeros((2, 8), np.float32)))
    names = [m.make_secondary_stream_name("Radio", i) for i in (0, 2)]
    idx = [m.get_secondary_stream_index(n)
           for n in ("Radio__##3", "Radio", "Radio__##x")]
    return (out + got + sub_got
            + [s2 and s2.name for s2 in subs] + added + names + idx
            + [reg.remove_substream("Radio__##2"),
               reg.remove_substream("Radio"), reg.names(),
               [(h.source, h.source_type, h.stereo_data.shape)
                for h in hooks]])


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("scenario,jax_mod,port_mod", [
    (rechunker_scenario, jax_pump, pump),
    (guard_scenario, jax_pump, pump),
    (merger_scenario, jax_routing, routing),
    (sink_scenario, jax_sink, sink),
], ids=["Rechunker", "RealTimeGuard", "Merger+Splitter", "sink layer"])
def test_host_runtime_matches_jax(scenario, jax_mod, port_mod):
    _same(scenario(jax_mod), scenario(port_mod))


# ---------------------------------------------------------------------
# WAV IO, file source, recorder, config, metrics

def test_wav_files_byte_identical(tmp_path):
    rng = np.random.default_rng(8)
    iq = (rng.uniform(-0.9, 0.9, 1000)
          + 1j * rng.uniform(-0.9, 0.9, 1000)).astype(np.complex64)
    stereo = rng.uniform(-1.2, 1.2, (2, 480)).astype(np.float32)
    for name, data, bits in (("iq16", iq, 16), ("iq32", iq, 32),
                             ("st16", stereo, 16),
                             ("mono32", stereo[0], 32)):
        jp, pp = str(tmp_path / f"j_{name}.wav"), str(tmp_path / f"p_{name}.wav")
        jax_wav.write_wav(jp, data, 48000, bits=bits)
        wav.write_wav(pp, data, 48000, bits=bits)
        assert open(jp, "rb").read() == open(pp, "rb").read(), name
        for j, p in zip(jax_wav.read_wav_iq(pp), wav.read_wav_iq(pp)):
            np.testing.assert_array_equal(j, p)
    for bits in (16, 32):
        jp, pp = str(tmp_path / "j_rec.wav"), str(tmp_path / "p_rec.wav")
        recs = (jax_recorder.WavRecorder(jp, 48000, channels=2, bits=bits),
                recorder.WavRecorder(pp, 48000, channels=2, bits=bits))
        for r in recs:
            r.write(stereo)
            r.write(stereo[:, :7])
            r.close()
        assert open(jp, "rb").read() == open(pp, "rb").read(), bits
    name = "baseband_14100000Hz_17-42-35_04-08-2023.wav"
    assert (wav.parse_capture_filename(name)
            == jax_wav.parse_capture_filename(name))
    assert (recorder.WavRecorder.capture_name("rec", 1e8)[:16]
            == jax_recorder.WavRecorder.capture_name("rec", 1e8)[:16])


@pytest.mark.parametrize("loop", [False, True])
def test_file_source_blocks_match_jax(tmp_path, loop):
    rng = np.random.default_rng(9)
    x = (0.1 * (rng.standard_normal(5300)
                + 1j * rng.standard_normal(5300))).astype(np.complex64)
    p = str(tmp_path / "baseband_7000000Hz_01-02-03_04-05-2023.wav")
    wav.write_wav(p, x, 200000, bits=32)
    js, ps = jax_file_source.FileSource(p, loop=loop), \
        file_source.FileSource(p, loop=loop)
    assert (ps.samplerate, ps.block_len, ps.center_freq, len(ps)) == (
        js.samplerate, js.block_len, js.center_freq, len(js)) == (
        200000, 1000, 7e6, 5300)
    jb, pb = js.blocks(), ps.blocks()
    for _ in range(13 if loop else 6):
        np.testing.assert_array_equal(next(jb), next(pb))
    if not loop:
        assert next(pb, None) is None and next(jb, None) is None


def test_config_manager_matches_jax(tmp_path):
    defaults = {"a": 1, "nested": {"x": 1, "y": [1, 2]}, "s": "v"}
    on_disk = {"a": 5, "nested": {"x": 9}}
    out = []
    for side, mod in (("j", jax_config), ("p", config)):
        path = str(tmp_path / side / "config.json")
        os.makedirs(os.path.dirname(path))
        with open(path, "w") as f:
            json.dump(on_disk, f)
        cm = mod.ConfigManager()
        cm.set_path(path)
        cm.load(defaults)                  # merges defaults, resaves
        with open(path) as f:
            merged = json.load(f)
        cm.enable_autosave(interval_s=0.05)
        with cm.acquire() as conf:
            conf["a"] = 7
        deadline = time.time() + 10
        while time.time() < deadline:
            with open(path) as f:
                if json.load(f)["a"] == 7:
                    break
            time.sleep(0.02)
        with cm.acquire() as conf:
            conf["late"] = True            # saved at disable
        cm.disable_autosave()
        with open(path) as f:
            out.append((merged, f.read()))
    assert out[0] == out[1]
    assert out[1][0] == {"a": 5, "nested": {"x": 9, "y": [1, 2]}, "s": "v"}
    assert json.loads(out[1][1]) == dict(out[1][0], a=7, late=True)


def test_metrics_and_events_match_jax():
    levels = []
    for mod in (jax_metrics, metrics):
        m = mod.PeakLevelMeter()
        m.push(np.array([0.5, -1.0, 0.2]))
        row = [m.level_db()]
        for _ in range(50):
            m.push(np.array([0.001]))
        levels.append(row + [m.level_db(), m.peak])
    assert levels[0] == levels[1]
    t = metrics.StreamTracker(window_s=10.0)
    t.add(1000)
    time.sleep(0.02)
    t.add(1000)
    assert t.total == 2000 and t.rate() > 1000.0
    ev, got = Event(), []
    ev.bind(got.append)
    ev.emit(1)
    ev.unbind(got.append)
    ev.emit(2)
    assert got == [1]
    flog.info("serving units: {} {}", "log", 1)
    assert "serving units: log 1" in flog.dump()


# ---------------------------------------------------------------------
# StreamPump

PUMP_FS = 240_000.0
# the NFM chain's start-up from zero state, in audio samples of block 0
# (8.3 ms): there the discriminator turns the filters' rounding on a
# rising IF into audio, and the JAX package's own routes disagree
# (tests/test_torch_radio_bank.py's docstring)
PUMP_STARTUP = 400


def _pump_iq() -> np.ndarray:
    n = np.arange(int(PUMP_FS * 0.4))
    tone = 0.8 * np.sin(2 * np.pi * 1000 * n / PUMP_FS)
    return (0.5 * np.exp(1j * (2 * np.pi * 50e3 * n / PUMP_FS
                               + 2 * np.pi * np.cumsum(2500 * tone)
                               / PUMP_FS))).astype(np.complex64)


def _run_pump(sp, x):
    """``sp.run`` on ``x`` in 7 000-sample source blocks → (blocks,
    audio, spectra)."""
    audio, spectra = [], []
    n_blocks = sp.run([x[i:i + 7000] for i in range(0, len(x), 7000)],
                      sinks={DEMOD_NFM: audio.append},
                      spectrum=spectra.append)
    return n_blocks, audio, spectra


def test_stream_pump_matches_its_steps():
    """The port's StreamPump (one block of lag between the steps and the
    sinks) gives what calling its front end and bank by hand gives."""
    fs, x = PUMP_FS, _pump_iq()
    fe = IQFrontEnd(fs, fft_size=1024, fft_rate=20.0, device="cpu")
    bank = RadioBank(fs, [VFOSpec("v0", DEMOD_NFM, 50e3)], device="cpu")
    sp = pump.StreamPump(fe, bank, block_len=20_000)
    assert sp.block_len % sp.granularity == 0
    n_blocks, audio, spectra = _run_pump(sp, x)
    L = sp.block_len
    assert n_blocks == len(x) // L == len(audio) == len(spectra)
    fst, bst, bp = fe.init_state(), bank.init_state(), bank.make_params()
    for b in range(n_blocks):
        (bb, spec), fst = fe.apply(None, fst, torch.from_numpy(
            x[b * L:(b + 1) * L]))
        outs, bst = bank.apply(bp, bst, bb)
        np.testing.assert_array_equal(audio[b], outs[DEMOD_NFM].numpy())
        np.testing.assert_array_equal(spectra[b], spec.numpy())
    assert sp.run(iter([x[:L]] * 3), max_blocks=2) == 2


def test_stream_pump_matches_jax():
    """The port's StreamPump against the JAX package's on the same
    source blocks: the same block length, granularity and block count;
    each block's audio >= 80 dB (block 0 past the chain's start-up) and
    its spectra by ``assert_spectra_close``."""
    x = _pump_iq()
    spec = [("v0", DEMOD_NFM, 50e3)]
    jp = jax_pump.StreamPump(
        JaxFrontEnd(PUMP_FS, fft_size=1024, fft_rate=20.0),
        jax_bank.RadioBank(PUMP_FS, [jax_bank.VFOSpec(*v) for v in spec]),
        block_len=20_000)
    pp = pump.StreamPump(
        IQFrontEnd(PUMP_FS, fft_size=1024, fft_rate=20.0, device="cpu"),
        RadioBank(PUMP_FS, [VFOSpec(*v) for v in spec], device="cpu"),
        block_len=20_000)
    assert (pp.block_len, pp.granularity) == (jp.block_len, jp.granularity)
    jn, ja, js = _run_pump(jp, x)
    pn, pa, ps = _run_pump(pp, x)
    assert pn == jn == len(x) // pp.block_len == len(pa) == len(ps)
    for b in range(pn):
        assert pa[b].shape == ja[b].shape and pa[b].dtype == ja[b].dtype
        q = PUMP_STARTUP if b == 0 else 0
        assert snr_db(ja[b][..., q:], pa[b][..., q:]) >= 80.0, b
        assert_spectra_close(js[b], ps[b])
