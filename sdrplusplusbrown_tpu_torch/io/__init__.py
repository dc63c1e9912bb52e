from .wav import read_wav_iq, write_wav, parse_capture_filename
from .file_source import FileSource
from .recorder import WavRecorder
from .network_source import NetworkSource, RtlTcpSource
from .network_sink import NetworkSink
from .spyserver_source import SpyServerSource
from .hl2_source import HL2Source
from .kiwisdr_source import KiwiSDRSource

__all__ = ["read_wav_iq", "write_wav", "parse_capture_filename",
           "FileSource", "WavRecorder", "NetworkSource", "RtlTcpSource",
           "NetworkSink", "SpyServerSource", "HL2Source", "KiwiSDRSource"]
