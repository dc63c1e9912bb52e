"""Application shell: config, the source, radio module instances, sinks
and the streaming loop (counterpart of sdrplusplusbrown_tpu/app.py; the
headless analog of the reference's core.cpp/MainWindow wiring,
reference core/src/core.cpp:437-912, gui/main_window.cpp:104-248),
driven through the HTTP control plane (server/http_server.py).

The app runs on ``device`` (CUDA unless the caller asks for the CPU):
the front end and every radio keep their params and state there; each
block goes to the card once, and the baseband stays there between the
radios.  Host copies are the JAX app's: the baseband (the IF spectrum
ring), the spectrum lines and each radio's audio.

Ported: every source of the JAX app — ``none``, ``file``, ``network``
(raw UDP/TCP IQ), ``rtl_tcp``, ``spyserver``, ``kiwisdr``, ``hl2`` (the
Hermes Lite 2, also the app's transmitter) and ``sdrpp_server`` (a
remote ``server/stream_server.py``, through ``server/stream_client.py``):
each is host code that yields numpy blocks, ``tune`` retunes one with a
tuner and ``shutdown`` closes it; the ``loopback`` transmitter (the
``transmitter`` config key), keyed by rigctl's ``T``; the
``iq_exporter``, ``scanner``, ``frequency_manager``, ``recorder`` and
``scheduler`` modules (``modules/``), the digital decoders
``m17_decoder``, ``kg_sstv_decoder``, ``ryfi_decoder`` and
``meteor_demodulator`` (each on the host baseband through its own RxVFO,
demod and, but Meteor, Viterbi on the app's device), the wideband
decoders ``vor_receiver``, ``weather_sat_decoder`` (NOAA HRPT),
``atv_decoder``, ``falcon9_decoder`` and ``dab_decoder`` (each through
its RxVFO, where the source is wider than its channel, and its demod on
the app's device, its framer on the host; DAB's OFDM front end is host
numpy, as in the JAX package), the voice and trunking decoders
``ch_extravhf_decoder`` (DMR, P25, D-STAR, X2-TDMA, NXDN and ProVoice
frame sync and the burst layer past it, CTCSS and DCS) and
``ch_tetra_demodulator`` (the TETRA downlink's lower and upper MAC), each
through its RxVFO and demod on the app's device and one copy a block to
its host decoder, ``radio
modules with every demod (the RAW demod and plugin demods registered with
``models.radio.register_demod_provider`` among them; ``list_demods``),
their noise blanker and FM IF filter (``set_nb``, ``set_fmif``), their
audio noise reduction (``set_afnr logmmse|omlsa``, ops/logmmse.py and
ops/omlsa.py, on a host buffer as the JAX app runs it) and, on a WFM
radio, RDS (the ``rds`` module key and ``set_rds``: the radio's 5 kS/s
RDS tap through ``RDSDemod`` on the card after each ``Radio.apply``, its
hard bits and valid mask read back in one copy a block into the host
``RDSDecoder``, read by ``get_rds``), the IF noise reduction (the
``ifnr`` config key and ``set_ifnr_enabled``: a second front end
carrying ``IFNRLogMMSE`` as its preprocessor, primed once a pump session,
shed by the real-time guard), and the ``recorder``, ``network`` and
``mpeg`` sinks.  What the JAX app has beyond that is refused by name: its
other module types raise ``NotImplementedError`` when configured.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .utils.config import ConfigManager
from .utils.flog import flog
from .utils.event import Event
from .utils.metrics import PeakLevelMeter, StreamTracker
from .models.iq_frontend import IQFrontEnd
from .models.radio import Radio, DEMOD_NAMES, DEMOD_IDS, DEMOD_PROVIDERS
from .models.rds import RDSDecoder, RDSDemod
from .models.waterfall import Waterfall
from .ops.logmmse import AFNRLogMMSE, IFNRLogMMSE
from .ops.omlsa import OMLSA
from .ops.spectrum import calculate_vfo_signal_info
from .io.file_source import FileSource
from .io.recorder import WavRecorder
from .models.trx import LoopbackTransmitter, Transmitter
from .runtime.block import entry_device, to_device
from .runtime.migrate import migrate_state
from .runtime.pump import Rechunker, RealTimeGuard
from .runtime.sink import (PRIO_DEMOD, StreamHook, StreamRegistry,
                           get_secondary_stream_index)

# reference demodulators/*.h getMinBandwidth/getMaxBandwidth
DEMOD_BW_LIMITS = {
    0: (1000.0, 50_000.0),     # NFM: max = IF rate
    1: (50_000.0, 500_000.0),  # WFM
    2: (1000.0, 15_000.0),     # AM
    3: (1000.0, 12_000.0),     # DSB: IF/2
    4: (500.0, 12_000.0),      # USB
    5: (50.0, 500.0),          # CW
    6: (500.0, 12_000.0),      # LSB
    7: (48_000.0, 48_000.0),   # RAW
}

DEFAULT_CONFIG = {
    "version": 1,
    "frequency": 100_000_000.0,
    "source": {"type": "none", "path": "", "samplerate": 1_000_000.0},
    "fftSize": 65536,
    "fftRate": 20,
    "fftWindow": "nuttall",
    "decimation": 1,
    "dcBlocking": False,
    "invertIQ": False,
    "modules": {},
    "sinks": {},
    "streamVolumes": {},
}

SPECTRUM_BUF_SIZE = 16384  # IF spectrum ring (reference radio_module.h:78)

#: what the JAX app serves and the port does not yet: refused by name
UNPORTED_MODULES = (
    "ft8_decoder", "tci_server", "websdr_view", "reports_monitor",
    "discord_integration", "signal_detector")


def describe_device(dev: torch.device) -> str:
    """'cuda:0 (<card name>)' or 'cpu', for the log."""
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return f"cuda:{idx} ({torch.cuda.get_device_name(idx)})"
    return str(dev)


class ModuleComManager:
    """String-keyed cross-module interface registry
    (reference: core/src/module_com.h:13-25 — modules publish duck-typed
    interfaces other modules look up by name)."""

    def __init__(self):
        self._interfaces: Dict[str, object] = {}

    def register_interface(self, name: str, obj) -> bool:
        if name in self._interfaces:
            return False
        self._interfaces[name] = obj
        return True

    def unregister_interface(self, name: str):
        self._interfaces.pop(name, None)

    def interface_exists(self, name: str) -> bool:
        return name in self._interfaces

    def get_interface(self, name: str):
        return self._interfaces.get(name)


class ModuleInstance:
    """reference: ModuleManager::Instance (core/src/module.h:35-52)."""

    def __init__(self, name: str):
        self.name = name
        self._enabled = True

    def post_init(self):
        pass

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def is_enabled(self) -> bool:
        return self._enabled

    def module_type(self) -> str:
        return "unknown"

    def shutdown(self):
        pass

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        return {"error": f"unknown command: {cmd}"}


class RadioModuleInstance(ModuleInstance):
    """The demodulation app module (reference decoder_modules/radio): one
    ``Radio`` built with the squelch on (and the noise blanker and the FM
    IF filter when set, and RDS on a WFM radio), stepped once a block by
    the pump on the shared baseband, then the RDS demod and decoder, then
    the audio NR when one is selected."""

    def __init__(self, name: str, app: "SDRApp", demod: str = "WFM",
                 offset_hz: float = 0.0, bandwidth: Optional[float] = None,
                 rds: bool = False):
        super().__init__(name)
        self.app = app
        self._mtx = threading.RLock()
        self.rds_enabled = bool(rds)
        self.rds_demod = None
        self.rds_state = None
        self.rds_decoder = None
        # IF chain flags (reference radio_module.h:92-98)
        self.nb_enabled = False
        self.fmif_enabled = False
        self.squelch_level = -100.0
        self.volume = 1.0
        self.muted = False
        self.level_meter = PeakLevelMeter()
        # audio NR (reference AFNRLogMMSE / AFNR_OMLSA_MCRA,
        # noise_reduction_logmmse/src/{af_nr.h,omlsa_mcra.h})
        self.afnr_mode = "off"            # off | logmmse | omlsa
        self.afnr = None
        self.afnr_state = None
        self._afnr_buf = np.zeros((2, 0), np.float32)
        self._afnr_primed = False
        self.offset_hz = float(offset_hz)
        self.radio: Optional[Radio] = None
        self.state = None
        self.spectrum_ring = np.zeros(SPECTRUM_BUF_SIZE, np.complex64)
        self.audio_event: Event = Event()
        self._build(DEMOD_IDS.get(demod.upper(), demod.upper())
                    if isinstance(demod, str) else int(demod), bandwidth)

    def module_type(self) -> str:
        return "radio"

    def _build(self, demod_id, bandwidth: Optional[float],
               migrate: bool = False):
        """(Re)build the pipeline on the app's device for ``demod_id`` at
        ``bandwidth`` (None: the demod's default).  A demod or bandwidth
        the port cannot build raises and leaves the module as it was.
        With ``migrate=True`` the carried DSP state (filter tails,
        NCO/PLL/AGC) survives the reconfiguration via runtime.migrate
        resize rules — the reference's click-free retune (fir.h:33-54,
        radio_module.h:655-774)."""
        t0 = time.perf_counter()
        with self._mtx:
            use_rds = self.rds_enabled and demod_id == 1    # WFM only
            radio = Radio(self.app.samplerate, demod_id,
                          bandwidth=bandwidth, offset_hz=self.offset_hz,
                          squelch_enabled=True,
                          squelch_level=self.squelch_level,
                          nb_enabled=self.nb_enabled,
                          fmif_enabled=self.fmif_enabled, rds=use_rds,
                          device=self.app.device)
            self.state = migrate_state(self.state if migrate else None,
                                       radio.init_state(()))
            self.radio, self.demod_id = radio, demod_id
            self.params = radio.make_params(self.offset_hz)
            self.bandwidth = radio.bandwidth
            if use_rds:
                self.rds_demod = RDSDemod()
                self.rds_state = migrate_state(
                    self.rds_state if migrate else None,
                    to_device(self.rds_demod.init_state(()),
                              self.app.device))
                self.rds_decoder = RDSDecoder()
            else:
                self.rds_demod = self.rds_state = self.rds_decoder = None
        self.last_switch_us = (time.perf_counter() - t0) * 1e6
        # reference logs demod-switch latency in µs (radio_module.h:474)
        flog.info("Radio[{}]: demod {} ready in {:.0f} us", self.name,
                  self.radio.demod_name, self.last_switch_us)

    def set_offset(self, offset_hz: float):
        self.offset_hz = float(offset_hz)
        # keep the runtime squelch level across retunes
        self.params = self.radio.make_params(
            self.offset_hz, squelch_level=self.squelch_level)

    def set_bandwidth(self, bandwidth_hz: float):
        self._build(self.demod_id, float(bandwidth_hz), migrate=True)

    def select_demod(self, demod_id):
        """Switch to demod ``demod_id`` (an id, or a provider's name) at
        its default bandwidth, carrying the state over."""
        self._build(demod_id if isinstance(demod_id, str) else int(demod_id),
                    None, migrate=True)

    def rds_step(self, rds_bb: torch.Tensor) -> None:
        """The RDS tap of one block through ``RDSDemod`` on the device,
        then its hard bits and valid mask to the host decoder in one
        device-to-host copy (the JAX app's ``np.asarray``)."""
        (hard, valid), self.rds_state = self.rds_demod.apply(
            None, self.rds_state, rds_bb)
        hv = torch.stack([hard, valid.to(torch.uint8)]).cpu().numpy()
        self.rds_decoder.push_bits(hv[0][hv[1].astype(bool)])

    def _afnr_process(self, audio: np.ndarray) -> np.ndarray:
        """Run the selected audio NR with its own block alignment: the
        audio joins a host buffer, LogMMSE is primed on its first
        NOISE_FRAMES·Slen samples, whole multiples of ``in_multiple`` go
        to the device, and the output lags by the buffered remainder
        (the reference's worker accumulation, af_nr.h:290-340)."""
        nr = self.afnr
        if nr is None:
            return audio
        dev = self.app.device
        self._afnr_buf = np.concatenate([self._afnr_buf, audio], axis=-1)
        core = getattr(nr, "core", None)
        if core is not None and not self._afnr_primed:
            need = core.NOISE_FRAMES * core.Slen
            if self._afnr_buf.shape[-1] < need:
                return np.zeros((2, 0), np.float32)
            x0 = torch.from_numpy(self._afnr_buf[..., :need].astype(
                np.complex64)).to(dev)
            self.afnr_state = {**self.afnr_state,
                               **nr.prime(self.afnr_state, x0)}
            self._afnr_primed = True
        g = nr.in_multiple
        n = (self._afnr_buf.shape[-1] // g) * g
        if n == 0:
            return np.zeros((2, 0), np.float32)
        blk, self._afnr_buf = (self._afnr_buf[..., :n],
                               self._afnr_buf[..., n:])
        x = blk.astype(np.complex64) if core is not None \
            else blk.astype(np.float32)
        y, self.afnr_state = nr.apply(None, self.afnr_state,
                                      torch.from_numpy(x).to(dev))
        out = y.cpu().numpy()
        return np.real(out).astype(np.float32) if np.iscomplexobj(out) \
            else out

    def set_afnr(self, args: str) -> dict:
        """Select the audio NR ("off", "logmmse" or "omlsa"), built for
        the radio's audio rate with a fresh state and an empty buffer."""
        mode = args.strip().lower() or "off"
        if mode not in ("off", "logmmse", "omlsa"):
            return {"error": f"unknown afnr mode '{args}'"}
        nr, state = None, None
        if mode == "omlsa":
            nr = OMLSA(self.radio.audio_samplerate)
        elif mode == "logmmse":
            nr = AFNRLogMMSE(self.radio.audio_samplerate)
        if nr is not None:
            state = to_device(nr.init_state((2,)), self.app.device)
        with self._mtx:
            self.afnr_mode = mode
            self.afnr_state = state
            self._afnr_buf = np.zeros((2, 0), np.float32)
            self._afnr_primed = False
            self.afnr = nr
        return {"status": "ok", "afnr": mode}

    def push_if_spectrum(self, iq_block: np.ndarray):
        n = min(len(iq_block), SPECTRUM_BUF_SIZE)
        self.spectrum_ring = np.roll(self.spectrum_ring, -n)
        self.spectrum_ring[-n:] = iq_block[-n:]

    # ------------------------------------------------------------------
    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd in ("set_demod", "set_demodulator"):
            name = args.strip().upper()
            if name in DEMOD_PROVIDERS:
                self.select_demod(name)
                return {"status": "ok", "demod": name, "id": -1}
            try:
                did = DEMOD_IDS[name] if name in DEMOD_IDS else int(args)
                self.select_demod(did)
                return {"status": "ok", "demod": DEMOD_NAMES[did],
                        "id": did}
            except NotImplementedError as e:
                return {"error": str(e)}
            except (ValueError, IndexError, KeyError):
                return {"error": f"unknown demod '{args}'"}
        if cmd == "set_vfo_bandwidth":
            try:
                self.set_bandwidth(float(args))
                return {"status": "ok", "bandwidth": self.bandwidth}
            except ValueError:
                return {"error": f"bad bandwidth '{args}'"}
        if cmd == "get_demod":
            return {"demod": self.radio.demod_name, "id": self.demod_id}
        if cmd == "list_demods":
            demods = [{"name": n, "id": i}
                      for i, n in enumerate(DEMOD_NAMES)]
            demods += [{"name": n, "id": -1} for n in sorted(DEMOD_PROVIDERS)]
            return {"radio": self.name, "demods": demods}
        if cmd == "get_vfo_bandwidth":
            lo, hi = DEMOD_BW_LIMITS.get(
                self.demod_id, (0.0, self.radio.if_rate))
            return {"vfo_bandwidth": self.bandwidth,
                    "lower_offset": self.offset_hz - self.bandwidth / 2,
                    "upper_offset": self.offset_hz + self.bandwidth / 2,
                    "module_bandwidth": self.bandwidth,
                    "min_bandwidth": lo, "max_bandwidth": hi}
        if cmd == "set_freq":
            try:
                freq = float(args)
            except ValueError:
                return {"error": f"invalid frequency: '{args}'"}
            self.app.tune(freq)
            return {"status": "ok", "frequency": freq}
        if cmd == "set_squelch":
            try:
                self.squelch_level = float(args)
            except ValueError:
                return {"error": f"bad level '{args}'"}
            self.params = self.radio.make_params(
                self.offset_hz, squelch_level=self.squelch_level)
            return {"status": "ok", "level": self.squelch_level}
        if cmd in ("set_nb", "set_fmif"):
            # the JAX app rebuilds the radio from a fresh state
            on = args.strip().lower() in ("1", "true", "on")
            if cmd == "set_nb":
                self.nb_enabled = on
            else:
                self.fmif_enabled = on
            self._build(self.demod_id, self.bandwidth)
            return {"status": "ok", cmd[4:]: on}
        if cmd == "set_rds":
            # the JAX app rebuilds the radio from a fresh state
            self.rds_enabled = args.strip().lower() in ("1", "true", "on")
            self._build(self.demod_id, self.bandwidth)
            return {"status": "ok", "rds": self.rds_enabled}
        if cmd == "set_volume":
            try:
                self.volume = float(args)
                return {"status": "ok", "volume": self.volume}
            except ValueError:
                return {"error": f"bad volume '{args}'"}
        if cmd == "get_level":
            return {"level_db": round(self.level_meter.level_db(), 2)}
        if cmd == "set_afnr":
            return self.set_afnr(args)
        if cmd == "get_afnr":
            return {"afnr": self.afnr_mode}
        if cmd == "get_rds":
            if self.rds_decoder is None:
                return {"error": "rds not enabled"}
            return self.rds_decoder.status()
        if cmd == "get_snr":
            snr = self.app.vfo_snr(self.name)
            return {"snr": snr if snr is not None else -1.0}
        if cmd == "get_spectrum":
            num_buckets = 256
            if "," in args:
                try:
                    num_buckets = int(args.split(",")[1])
                except ValueError:
                    pass
            num_buckets = max(8, min(2048, num_buckets))
            snap = self.spectrum_ring
            n = len(snap)
            win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / (n - 1)))
            power = np.abs(np.fft.fftshift(np.fft.fft(snap * win))) ** 2
            # the ring holds wideband baseband; slice this VFO's passband
            # (the reference rings post-VFO IF samples — same product:
            # "what's inside my passband", radio_module.h:78-89)
            sr = self.app.frontend.effective_sr
            half_span = max(self.bandwidth, sr / num_buckets * 8)
            lo = int((max(self.offset_hz - half_span, -sr / 2) / sr + 0.5)
                     * n)
            hi = int((min(self.offset_hz + half_span, sr / 2) / sr + 0.5)
                     * n)
            seg = power[max(lo, 0):max(hi, 1)]
            if len(seg) < num_buckets:
                seg = np.pad(seg, (0, num_buckets - len(seg)),
                             constant_values=seg.min() if len(seg) else 1e-30)
            maxp = max(float(seg.max()), 1e-30)
            bpb = len(seg) // num_buckets
            avg = seg[:bpb * num_buckets].reshape(num_buckets, bpb).mean(1)
            db = 10 * np.log10(avg / maxp + 1e-10)
            return {"spectrum": [round(float(v), 3) for v in db],
                    "num_buckets": num_buckets, "fft_size": n,
                    "span_hz": 2 * half_span, "max_bin": maxp}
        return super().handle_debug_command(cmd, args)


class SDRApp:
    def __init__(self, root: str, run_pump: bool = True, device="cuda"):
        self.device = entry_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.config = ConfigManager()
        self.config.set_path(os.path.join(root, "config.json"))
        self.config.load(DEFAULT_CONFIG)

        with self.config.acquire(False) as conf:
            src = dict(conf["source"])
            self.samplerate = float(src.get("samplerate", 1_000_000.0))
            self.frequency = float(conf.get("frequency", 100e6))
            self._fft_size = int(conf.get("fftSize", 65536))
            self._fft_rate = float(conf.get("fftRate", 20))
            self._fft_window = conf.get("fftWindow", "nuttall")
            self._decim = int(conf.get("decimation", 1))
            self._dc = bool(conf.get("dcBlocking", False))
            self._inv = bool(conf.get("invertIQ", False))
            mod_conf = dict(conf.get("modules", {}))
            self.sink_sel = dict(conf.get("sinks", {}))
            self.ifnr_enabled = bool(conf.get("ifnr", False))
            txc = dict(conf.get("transmitter", {}))
            self.pump_manual = (conf.get("pump", "thread") == "manual")
        # refused before the source and the exporters open their sockets
        for name, mc in mod_conf.items():
            mtype = mc.get("type", "radio")
            if mtype in UNPORTED_MODULES:
                raise NotImplementedError(f"module type '{mtype}' (module "
                                          f"'{name}') is not ported yet")

        self.source = None
        stype = src.get("type")
        if stype == "file" and src.get("path"):
            self.source = FileSource(src["path"],
                                     loop=bool(src.get("loop", True)))
            self.samplerate = self.source.samplerate
            if self.source.center_freq:
                self.frequency = self.source.center_freq
        elif stype == "network":
            # raw UDP/TCP IQ (reference source_modules/network_source)
            from .io.network_source import NetworkSource
            self.source = NetworkSource(
                host=src.get("host", "localhost"),
                port=int(src.get("port", 1234)),
                protocol=src.get("protocol", "udp"),
                sample_type=src.get("sampleType", "int16"),
                samplerate=float(src.get("samplerate", 1_000_000.0)))
            self.samplerate = self.source.samplerate
        elif stype == "rtl_tcp":
            # rtl_tcp protocol client (reference
            # source_modules/rtl_tcp_source)
            from .io.network_source import RtlTcpSource
            self.source = RtlTcpSource(
                host=src.get("host", "localhost"),
                port=int(src.get("port", 1234)),
                samplerate=float(src.get("samplerate", 2_400_000.0)))
            self.samplerate = self.source.samplerate
            self.source.tune(self.frequency)
        elif stype == "spyserver":
            # SpyServer protocol client (reference
            # source_modules/spyserver_source)
            from .io.spyserver_source import SpyServerSource
            self.source = SpyServerSource(
                host=src.get("host", "localhost"),
                port=int(src.get("port", 5555)),
                srate_index=int(src.get("sampleRateId", 0)),
                gain=int(src.get("gain", 0)))
            self.samplerate = self.source.samplerate
            self.source.start_stream(self.frequency)
        elif stype == "kiwisdr":
            # remote KiwiSDR IQ (reference source_modules/kiwisdr_source)
            from .io.kiwisdr_source import KiwiSDRSource
            self.source = KiwiSDRSource(
                host=src.get("host", "localhost"),
                port=int(src.get("port", 8073)),
                freq_hz=self.frequency)
            self.samplerate = self.source.samplerate
        elif stype == "hl2":
            # Hermes Lite 2 TRX (reference source_modules/hl2_source):
            # also the app's transmitter below, as the reference sets
            # sigpath::transmitter (main.cpp)
            from .io.hl2_source import HL2Source
            self.source = HL2Source(
                host=src.get("host", "localhost"),
                port=int(src.get("port", 1024)),
                samplerate=int(src.get("samplerate", 384_000)),
                adc_gain=int(src.get("adcGain", 0)))
            self.samplerate = self.source.samplerate
            self.source.tune(self.frequency)
        elif stype == "sdrpp_server":
            # a remote StreamServer (reference
            # source_modules/sdrpp_server_source): its samplerate comes
            # from the handshake, its blocks are host numpy like a file's
            from .server.stream_client import StreamClient
            self.source = StreamClient(
                src.get("host", "localhost"), int(src.get("port", 5259)),
                password=src.get("password", ""),
                compression=src.get("compression", "none"))
            self.samplerate = float(self.source.samplerate)

        self.frontend = IQFrontEnd(
            self.samplerate, decim_ratio=self._decim, dc_blocking=self._dc,
            invert_iq=self._inv, fft_size=self._fft_size,
            fft_rate=self._fft_rate, fft_window=self._fft_window,
            device=self.device)
        # the optional baseband (IF) noise reduction: a second front end
        # carrying IFNRLogMMSE as its preprocessor (reference IFNRLogMMSE
        # on the IQ front end, noise_reduction_logmmse/src/main.cpp:165,
        # 227-231)
        self.ifnr = None
        self.frontend_nr = None
        self.ifnr_primed = False
        self.ifnr_stop_reason = ""
        if self.ifnr_enabled:
            self._build_ifnr()

        self.baseband_event: Event = Event()
        self.spectrum_event: Event = Event()
        self.module_com = ModuleComManager()
        # sink layer: per-module streams with priority merger + secondary
        # substreams + the StreamHook bus (reference SinkManager, sink.h)
        self.stream_registry = StreamRegistry()
        # TX hardware (reference trx.h): the HL2 source is its own
        # transmitter; a ``loopback`` one keeps the TX IQ in memory
        self.transmitter = None
        if isinstance(self.source, Transmitter):
            self.transmitter = self.source
        if txc.get("type") == "loopback":
            self.transmitter = LoopbackTransmitter()

        self.modules: Dict[str, ModuleInstance] = {}
        for name, mc in mod_conf.items():
            mtype = mc.get("type", "radio")
            if mtype == "radio":
                self.modules[name] = RadioModuleInstance(
                    name, self, demod=mc.get("demod", "WFM"),
                    offset_hz=mc.get("offset", 0.0),
                    bandwidth=mc.get("bandwidth"),
                    rds=mc.get("rds", False))
            elif mtype == "scanner":
                from .modules.scanner import ScannerModule
                self.modules[name] = ScannerModule(
                    name, self, vfo=mc.get("vfo", "Radio"),
                    **{k: mc[k] for k in
                       ("start_freq", "stop_freq", "interval", "level")
                       if k in mc})
            elif mtype == "frequency_manager":
                from .modules.frequency_manager import FrequencyManagerModule
                self.modules[name] = FrequencyManagerModule(
                    name, self, bookmarks=mc.get("bookmarks"))
            elif mtype == "recorder":
                from .modules.recorder_module import RecorderModule
                self.modules[name] = RecorderModule(
                    name, self, directory=mc.get("directory"))
            elif mtype == "iq_exporter":
                from .modules.iq_exporter import IQExporterModule
                self.modules[name] = IQExporterModule(
                    name, self, port=mc.get("port", 0),
                    mode=mc.get("mode", "baseband"),
                    stream=mc.get("stream", "Radio"),
                    pcm=mc.get("pcm", "i16"))
            elif mtype == "scheduler":
                from .modules.scheduler import SchedulerModule
                self.modules[name] = SchedulerModule(name, self)
            elif mtype == "meteor_demodulator":
                from .modules.meteor_module import MeteorDemodulatorModule
                self.modules[name] = MeteorDemodulatorModule(
                    name, self, offset_hz=mc.get("offset", 0.0),
                    symbolrate=mc.get("symbolrate", 72_000.0),
                    broken_modulation=mc.get("broken", False),
                    oqpsk=mc.get("oqpsk", False),
                    directory=mc.get("directory"))
            elif mtype == "m17_decoder":
                from .modules.m17_module import M17DecoderModule
                self.modules[name] = M17DecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "ryfi_decoder":
                from .modules.ryfi_module import RyfiDecoderModule
                self.modules[name] = RyfiDecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0),
                    baudrate=mc.get("baudrate", 720_000.0),
                    channel_sr=mc.get("channel_sr", 1_500_000.0))
            elif mtype == "kg_sstv_decoder":
                from .modules.kg_sstv_module import KGSSTVDecoderModule
                self.modules[name] = KGSSTVDecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "vor_receiver":
                from .modules.vor_module import VORReceiverModule
                self.modules[name] = VORReceiverModule(
                    name, self, offset_hz=mc.get("offset", 0.0),
                    integration_time=mc.get("integration_time", 1.0))
            elif mtype == "weather_sat_decoder":
                from .modules.weather_sat_module import \
                    WeatherSatDecoderModule
                self.modules[name] = WeatherSatDecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "atv_decoder":
                from .modules.atv_module import ATVDecoderModule
                self.modules[name] = ATVDecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "falcon9_decoder":
                from .modules.falcon9_module import Falcon9DecoderModule
                self.modules[name] = Falcon9DecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "dab_decoder":
                from .modules.dab_module import DABDecoderModule
                self.modules[name] = DABDecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "ch_extravhf_decoder":
                from .modules.extravhf_module import ExtraVhfDecoderModule
                self.modules[name] = ExtraVhfDecoderModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            elif mtype == "ch_tetra_demodulator":
                from .modules.tetra_module import TetraDemodulatorModule
                self.modules[name] = TetraDemodulatorModule(
                    name, self, offset_hz=mc.get("offset", 0.0))
            else:
                flog.warn("unknown module type '{}' for '{}'", mtype, name)

        self.sinks: Dict[str, object] = {}   # stream name -> recorder
        self.input_tracker = StreamTracker()
        self.waterfall = Waterfall(self._fft_size)
        self.last_spectrum: Optional[np.ndarray] = None
        self.rt_guard = RealTimeGuard()
        self._clock = time.perf_counter   # injectable for pacing tests
        self.running = False
        self.main_loop_started = False
        self._pump_thread: Optional[threading.Thread] = None
        # pump mode "manual": no pump thread — the control plane steps
        # the pipeline synchronously via /pump/step (progress is counted
        # in processed blocks, never in sleeps)
        self._pump_gen = None
        self._pump_step_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._lock = threading.RLock()
        self.run_pump = run_pump
        self.blocks_processed = 0
        # last: a config the port refuses above leaves no thread behind
        self.config.enable_autosave()

    # ------------------------------------------------------------------
    def _granularity(self) -> int:
        g = self.frontend.in_multiple
        for m in self.modules.values():
            if isinstance(m, RadioModuleInstance) and m.is_enabled():
                need = int(m.radio.in_multiple / self.frontend.ratio)
                g = math.lcm(g, need)
        return g

    def tune(self, freq: float):
        self.frequency = float(freq)
        # a source with a tuner gets the retune (reference
        # SourceManager::tune → the source's tuneHandler,
        # source.cpp:127-135): the sdrpp_server source retunes its server
        tuner = getattr(self.source, "tune", None)
        if callable(tuner):
            tuner(freq)
        with self.config.acquire() as conf:
            conf["frequency"] = freq

    def set_vfo_offset(self, name: str, offset_hz: float) -> bool:
        m = self.modules.get(name)
        if not isinstance(m, RadioModuleInstance):
            return False
        m.set_offset(offset_hz)
        return True

    def select_sink(self, stream: str, sink: str, **sink_conf) -> bool:
        """Attach a sink to a module's audio stream (or a secondary
        substream 'Name__##N'): 'recorder' records to WAV,
        'null_audio_sink'/'None' discards (reference
        SinkManager::setStreamSink, sink.h), 'network' streams int16 PCM
        to a host:port (reference sink_modules/network_sink), 'mpeg'
        MPEG-1 Layer I frames over TCP (io/mpeg_sink.py).  The sink's
        settings come from the config's ``network_sink``/``mpeg_sink``,
        overridden by ``sink_conf``; one that cannot connect leaves the
        stream without a sink and returns False."""
        base, idx = get_secondary_stream_index(stream)
        m = self.modules.get(base)
        if not isinstance(m, RadioModuleInstance):
            return False
        if idx > 0 and self.stream_registry.get(stream) is None:
            return False
        old = self.sinks.pop(stream, None)
        if hasattr(old, "close"):
            old.close()
        new_sink = None
        if sink == "recorder":
            rec_dir = os.path.join(self.root, "recordings")
            os.makedirs(rec_dir, exist_ok=True)
            path = os.path.join(rec_dir, WavRecorder.capture_name(
                f"sink_{stream}", self.frequency))
            # capture_name has 1 s resolution: two selects inside the
            # same second must not overwrite the first recording
            stem, ext = os.path.splitext(path)
            k = 1
            while os.path.exists(path):
                path = f"{stem}_{k}{ext}"
                k += 1
            new_sink = WavRecorder(path, m.radio.audio_samplerate,
                                   channels=2)
        elif sink == "network":
            from .io.network_sink import NetworkSink
            with self.config.acquire(False) as conf:
                nc = dict(conf.get("network_sink", {}))
            nc.update(sink_conf)
            try:
                new_sink = NetworkSink(
                    host=nc.get("host", "localhost"),
                    port=int(nc.get("port", 7355)),
                    protocol=nc.get("protocol", "udp"),
                    stereo=bool(nc.get("stereo", False)))
            except OSError as e:
                flog.error("network sink connect failed: {}", repr(e))
                return False
        elif sink == "mpeg":
            # MPEG-1 Layer I frames over TCP (the mpeg_adts_sink analog,
            # io/mpeg_sink.py; reference sink_modules/mpeg_adts_sink)
            from .io.mpeg_sink import MpegNetworkSink
            with self.config.acquire(False) as conf:
                nc = dict(conf.get("mpeg_sink", {}))
            nc.update(sink_conf)
            try:
                new_sink = MpegNetworkSink(
                    host=nc.get("host", "localhost"),
                    port=int(nc.get("port", 2020)),
                    samplerate=int(m.radio.audio_samplerate),
                    bitrate_kbps=int(nc.get("bitrate_kbps", 288)))
            except (OSError, AssertionError) as e:
                flog.error("mpeg sink connect failed: {}", repr(e))
                return False
        if new_sink is not None:
            self.sinks[stream] = new_sink
            if idx > 0:
                # substream sinks consume via the registry fan-out (the
                # pump only writes base-stream sinks directly)
                self.stream_registry.get(stream).bind(
                    lambda blk, _r=new_sink: _r.write(blk))
        self.sink_sel[stream] = sink
        with self.config.acquire() as conf:
            conf.setdefault("sinks", {})[stream] = sink
        return True

    def add_substream(self, base: str):
        """Create 'base__##N' (reference sink.h:117-135)."""
        if self.stream_registry.get(base) is None:
            m = self.modules.get(base)
            if not isinstance(m, RadioModuleInstance):
                return None
            self.stream_registry.register(base, m.radio.audio_samplerate)
        return self.stream_registry.add_substream(base)

    def _build_ifnr(self):
        """IFNRLogMMSE at the baseband rate and the front end that
        carries it (its own DC blocker and decimator state)."""
        self.ifnr = IFNRLogMMSE(self.frontend.effective_sr)
        self.frontend_nr = IQFrontEnd(
            self.samplerate, decim_ratio=self._decim, dc_blocking=self._dc,
            invert_iq=self._inv, fft_size=self._fft_size,
            fft_rate=self._fft_rate, fft_window=self._fft_window,
            preprocessors=[("ifnr", self.ifnr)], device=self.device)
        self.ifnr_primed = False

    def set_ifnr_enabled(self, enabled: bool):
        """Enable or disable the IF NR at run time, building it (unprimed,
        from a fresh state) if the app started without one."""
        if enabled and self.ifnr is None:
            self._build_ifnr()
        self.ifnr_enabled = bool(enabled)
        if enabled:
            self.ifnr_stop_reason = ""

    def vfo_snr(self, name: str):
        m = self.modules.get(name)
        if self.last_spectrum is None or not isinstance(
                m, RadioModuleInstance):
            return None
        out = calculate_vfo_signal_info(
            self.last_spectrum, m.offset_hz, m.bandwidth,
            self.frontend.effective_sr)
        if out is None:
            return None
        return float(out[1])

    # ------------------------------------------------------------------
    def start(self):
        with self._lock:
            if self.running:
                return
            self.running = True
            self._stop_evt.clear()
            if self.pump_manual:
                # synchronous mode: ready immediately; blocks flow only
                # through explicit pump_step() calls
                self.main_loop_started = True
            elif self.run_pump and self.source is not None:
                self._pump_thread = threading.Thread(
                    target=self._pump_loop, daemon=True)
                self._pump_thread.start()
            flog.info("SDRApp started (SR={} Hz, device {})",
                      self.samplerate, describe_device(self.device))

    def stop(self):
        with self._lock:
            if not self.running:
                return
            self.running = False
        self._stop_evt.set()
        if self._pump_thread:
            # long timeout: the pump's first block builds the kernels
            self._pump_thread.join(timeout=60)
            if self._pump_thread.is_alive():
                flog.warn("pump thread still busy at stop")
            self._pump_thread = None
        flog.info("SDRApp stopped")

    def _source_iter(self):
        """Source blocks with failure fallback: a dead source degrades to
        a null source so the pipeline keeps running (reference
        source.cpp:60-75 nullSource fallback)."""
        try:
            yield from self.source.blocks()
        except Exception as e:  # noqa: BLE001 — any source fault
            flog.error("source failed: {} — falling back to null source",
                       repr(e))
            B = max(int(self.samplerate // 200), 1024)
            while not self._stop_evt.is_set():
                time.sleep(B / self.samplerate)
                yield np.zeros(B, np.complex64)

    def _granularity_all(self) -> int:
        g = self._granularity()
        if self.ifnr_enabled and self.frontend_nr is not None:
            g = math.lcm(g, self.frontend_nr.in_multiple)
        return g

    def _pump_loop(self):
        for _ in self._pump_iter():
            pass

    def pump_step(self, n: int = 1) -> int:
        """Synchronously process up to ``n`` pipeline blocks (manual pump
        mode).  Returns the number actually processed (< n only at end of
        a non-looping source).  Serialized: concurrent HTTP calls queue
        on the step lock."""
        with self._pump_step_lock:
            if self._pump_gen is None:
                self._pump_gen = self._pump_iter()
            done = 0
            for _ in range(int(n)):
                try:
                    next(self._pump_gen)
                except StopIteration:
                    break
                done += 1
            return done

    def _pump_iter(self):
        """The pump as a generator: yields once per processed block so it
        can be driven by the pump thread (free-running) or stepped
        synchronously from the control plane (manual mode)."""
        fstate = self.frontend.init_state(())
        fstate_nr = None
        self.ifnr_primed = False    # (re)primed once a pump session
        primer = np.zeros(0, np.complex64)
        # real-time pacing guard and elastic degradation (reference
        # if_nr.h:117-139: the IF NR disables itself at >= 95 % of the
        # real-time budget twice in a row); rt_factor/blocks-behind
        # exposed at /status
        self.rt_guard = RealTimeGuard()
        rc: Optional[Rechunker] = None
        gran = None
        self.main_loop_started = True
        for blk in self._source_iter():
            if self._stop_evt.is_set():
                break
            g = self._granularity_all()
            if rc is None or g != gran:
                gran = g
                block_len = ((max(g, int(self.samplerate // 20)) + g - 1)
                             // g) * g
                self.pump_block_len = block_len
                rc = Rechunker(block_len)
            for chunk in rc.push(blk):
                use_nr = False
                if self.ifnr_enabled and self.ifnr is not None:
                    if not self.ifnr_primed:
                        primer = np.concatenate([primer, chunk])
                        core = self.ifnr.core
                        need = core.NOISE_FRAMES * core.Slen
                        if len(primer) >= need:
                            st0 = self.frontend_nr.init_state(())
                            st0["pre_ifnr"] = self.ifnr.prime(
                                st0["pre_ifnr"], torch.from_numpy(
                                    primer[:need]).to(self.device))
                            fstate_nr = st0
                            self.ifnr_primed = True
                            flog.info("IF NR primed ({} samples)", need)
                    use_nr = self.ifnr_primed
                t_start = self._clock()
                if use_nr:
                    (bb, spectra), fstate_nr = self.frontend_nr.apply(
                        None, fstate_nr, torch.from_numpy(chunk))
                else:
                    (bb, spectra), fstate = self.frontend.apply(
                        None, fstate, torch.from_numpy(chunk))
                budget = len(chunk) / self.samplerate
                if self.rt_guard.report(self._clock() - t_start, budget):
                    if use_nr:
                        # shed the heaviest optional stage when the
                        # block cannot keep real time
                        self.ifnr_enabled = False
                        self.ifnr_stop_reason = \
                            "Slow processing. Reduce sample rate."
                        flog.warn("IF NR self-disabled: {}",
                                  self.ifnr_stop_reason)
                    # re-arm either way: with nothing left to shed the
                    # guard keeps reporting rt_factor/blocks-behind
                    self.rt_guard.reset_policy()
                bb_np = bb.cpu().numpy()
                lines = spectra.cpu().numpy()
                for ln in lines:
                    self.waterfall.push_fft(ln)
                self.last_spectrum = lines[-1]
                self.baseband_event.emit(bb_np)
                self.spectrum_event.emit(self.last_spectrum)
                with self._lock:
                    mods = [m for m in self.modules.values()
                            if isinstance(m, RadioModuleInstance)
                            and m.is_enabled()]
                for m in mods:
                    with m._mtx:
                        if bb.shape[-1] % m.radio.in_multiple:
                            # demod switched mid-block; samples drop until
                            # the rechunker realigns (the analog of the
                            # reference's tempStop re-splice gap)
                            continue
                        # the baseband stays on the device between radios
                        y, m.state = m.radio.apply(m.params, m.state, bb)
                        if isinstance(y, tuple):
                            y, rds_bb = y
                            m.rds_step(rds_bb)
                    audio = y.cpu().numpy()
                    m.level_meter.push(audio)
                    if m.afnr is not None:
                        try:
                            with m._mtx:
                                audio = m._afnr_process(audio)
                        except Exception as e:  # NR swap race/misconfig:
                            flog.warn("afnr error, disabling: {}", repr(e))
                            m.afnr = None
                            continue
                        if audio.shape[-1] == 0:
                            continue
                    m.push_if_spectrum(bb_np)
                    # route through the sink layer: priority merger (TX
                    # inject preempts) → volume/mute → fan-out (reference
                    # SinkManager::Stream, sink.h:30-92)
                    stream = self.stream_registry.get(m.name)
                    if stream is None:
                        stream = self.stream_registry.register(
                            m.name, m.radio.audio_samplerate)
                    stream.volume = m.volume
                    stream.muted = m.muted
                    sink = self.sinks.get(m.name)
                    for out in stream.push_demod(audio):
                        m.audio_event.emit(out)
                        if hasattr(sink, "write"):
                            sink.write(out)
                    self.stream_registry.publish(StreamHook(
                        source=m.name,
                        source_type=StreamHook.SOURCE_DEMOD_OUTPUT,
                        priority=PRIO_DEMOD,
                        samplerate=m.radio.audio_samplerate,
                        stereo_data=audio))
                self.input_tracker.add(len(chunk))
                self.blocks_processed += 1
                yield self.blocks_processed

    # ------------------------------------------------------------------
    def status(self) -> dict:
        return {"ready": True, "httpListening": True,
                "mainLoopStarted": bool(self.main_loop_started
                                        or not self.run_pump
                                        or self.source is None),
                # real-time pacing observability (runtime/pump.py
                # RealTimeGuard; reference if_nr.h:117-139 analog)
                "rtFactor": round(self.rt_guard.rt_factor, 4),
                "secondsBehind": round(self.rt_guard.seconds_behind, 4),
                "ifnrEnabled": bool(self.ifnr_enabled),
                "ifnrStopReason": self.ifnr_stop_reason}

    def shutdown(self):
        self.stop()
        for m in self.modules.values():
            m.shutdown()
        # popped as closed: /exit shuts the app down before the entry
        # point's own shutdown does
        while self.sinks:
            self.sinks.popitem()[1].close()
        # a remote source says DISCONNECT and closes its socket
        closer = getattr(self.source, "close", None)
        if callable(closer):
            closer()
        self.config.disable_autosave()
