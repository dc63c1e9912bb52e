"""JSON configuration with defaults-repair and autosave (a copy of
sdrplusplusbrown_tpu/utils/config.py; host code).

reference: core/src/config.{h,cpp} — ConfigManager holds a JSON tree,
guarded by acquire/release, with a background autosave thread; defaults
are merged/repaired at load (core.cpp:539-835).
"""

from __future__ import annotations

import copy
import json
import os
import threading
from contextlib import contextmanager
from typing import Any, Optional


def merge_defaults(conf: dict, defaults: dict) -> bool:
    """Recursively add missing keys from defaults; True if changed."""
    changed = False
    for k, v in defaults.items():
        if k not in conf:
            conf[k] = copy.deepcopy(v)
            changed = True
        elif isinstance(v, dict) and isinstance(conf[k], dict):
            changed |= merge_defaults(conf[k], v)
    return changed


class ConfigManager:
    def __init__(self):
        self.conf: dict = {}
        self.path: Optional[str] = None
        self._mtx = threading.RLock()
        self._dirty = False
        self._autosave: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def set_path(self, path: str):
        self.path = path

    def load(self, defaults: dict, resave: bool = True):
        with self._mtx:
            if self.path and os.path.exists(self.path):
                try:
                    with open(self.path) as f:
                        self.conf = json.load(f)
                except (json.JSONDecodeError, OSError):
                    self.conf = {}
            else:
                self.conf = {}
            changed = merge_defaults(self.conf, defaults)
            if changed and resave:
                self._dirty = True
                self.save()

    def save(self):
        with self._mtx:
            if not self.path:
                return
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.conf, f, indent=2)
            os.replace(tmp, self.path)
            self._dirty = False

    @contextmanager
    def acquire(self, modified: bool = True):
        """reference config.h acquire/release discipline."""
        with self._mtx:
            yield self.conf
            if modified:
                self._dirty = True

    def enable_autosave(self, interval_s: float = 1.0):
        if self._autosave:
            return

        def loop():
            while not self._stop.wait(interval_s):
                with self._mtx:
                    if self._dirty:
                        self.save()

        self._autosave = threading.Thread(target=loop, daemon=True)
        self._autosave.start()

    def disable_autosave(self):
        self._stop.set()
        if self._autosave:
            self._autosave.join(timeout=3)
            self._autosave = None
        self._stop = threading.Event()
        if self._dirty:
            self.save()
