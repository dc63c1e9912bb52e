from .pocsag import POCSAGDecoder

__all__ = ["POCSAGDecoder"]
