"""App modules beyond the radio (counterpart of
sdrplusplusbrown_tpu/modules/): the IQ exporter, the scanner, the
frequency manager, the recorder and the scheduler; the app refuses the
others by name."""

from .scanner import ScannerModule
from .frequency_manager import FrequencyManagerModule
from .recorder_module import RecorderModule
from .scheduler import SchedulerModule
from .iq_exporter import IQExporterModule

__all__ = ["ScannerModule", "FrequencyManagerModule", "RecorderModule",
           "SchedulerModule", "IQExporterModule"]
