"""App modules beyond the radio (counterpart of
sdrplusplusbrown_tpu/modules/): the IQ exporter so far; the app refuses
the others by name."""

from .iq_exporter import IQExporterModule

__all__ = ["IQExporterModule"]
