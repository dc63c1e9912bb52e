from .config import ConfigManager
from .flog import flog
from .event import Event

__all__ = ["ConfigManager", "flog", "Event"]
