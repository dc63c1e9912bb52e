from .wav import read_wav_iq, write_wav, parse_capture_filename
from .file_source import FileSource
from .recorder import WavRecorder

__all__ = ["read_wav_iq", "write_wav", "parse_capture_filename",
           "FileSource", "WavRecorder"]
