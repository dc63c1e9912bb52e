"""Frequency manager — named bookmark lists with persistence and
apply-to-VFO (counterpart of sdrplusplusbrown_tpu/modules/
frequency_manager.py).

reference: misc_modules/frequency_manager (1475 LoC) — bookmark lists
(name → frequency, bandwidth, mode, owning VFO) stored in the module
config, applied to the selected VFO (tune + demod + bandwidth), plus the
debug-protocol surface the reference e2e drives
(e2e/test_frequency_manager.py, test_frequency_manager_tetra.py):
get_lists / get_current_list / set_current_list / get_bookmarks /
add_bookmark "Name|freq|bw|mode[|vfo]" / remove_bookmark /
apply_bookmark.
"""

from __future__ import annotations

import json
from typing import Dict

from ..app import ModuleInstance, RadioModuleInstance
from ..models.radio import DEMOD_IDS, DEMOD_NAMES


class FrequencyManagerModule(ModuleInstance):
    def __init__(self, name: str, app, bookmarks: Dict[str, dict]
                 | None = None):
        super().__init__(name)
        self.app = app
        self.lists: Dict[str, Dict[str, dict]] = {"Default": {}}
        self.current = "Default"
        if bookmarks:
            self.lists["Default"].update(bookmarks)
        self._load()

    def module_type(self) -> str:
        return "frequency_manager"

    # -- persistence ----------------------------------------------------
    def _load(self):
        with self.app.config.acquire(False) as conf:
            saved = conf.get("frequencyManager", {}).get(self.name, {})
        if "lists" in saved:                      # list-structured format
            for ln, bms in saved["lists"].items():
                self.lists.setdefault(ln, {}).update(bms)
            self.current = saved.get("selectedList", self.current)
            if self.current not in self.lists:
                self.current = next(iter(self.lists))
        else:                                     # legacy flat bookmarks
            self.lists["Default"].update(saved)

    def _save(self):
        with self.app.config.acquire() as conf:
            conf.setdefault("frequencyManager", {})[self.name] = {
                "selectedList": self.current, "lists": self.lists}

    # -- model ----------------------------------------------------------
    @property
    def bookmarks(self) -> Dict[str, dict]:
        return self.lists.setdefault(self.current, {})

    def add(self, name: str, frequency: float, mode: str = "NFM",
            bandwidth: float | None = None, vfo: str = "Radio"):
        self.bookmarks[name] = {"frequency": float(frequency),
                                "mode": mode, "bandwidth": bandwidth,
                                "vfo": vfo}
        self._save()

    def remove(self, name: str) -> bool:
        if name not in self.bookmarks:
            return False
        del self.bookmarks[name]
        self._save()
        return True

    def apply(self, bookmark: str, vfo: str | None = None):
        """Apply a bookmark to its stored VFO (or an override); returns
        the VFO name or None."""
        bm = self.bookmarks.get(bookmark)
        if bm is None:
            return None
        vfo = vfo or bm.get("vfo") or "Radio"
        m = self.app.modules.get(vfo)
        if not isinstance(m, RadioModuleInstance):
            # non-radio decoder modules (e.g. TETRA) get a plain retune
            # of their offset if they expose one (reference applies the
            # bookmark to whatever module owns the stored VFO)
            if m is not None and hasattr(m, "set_offset"):
                self.app.tune(bm["frequency"] - getattr(m, "offset_hz", 0.0))
                return vfo
            return None
        # tuner::TUNER_MODE_NORMAL semantics (reference core/src/gui/
        # tuner.cpp): a target inside the current span just moves the
        # VFO offset (file sources have a fixed center); outside it the
        # center is retuned so the bookmark lands at the VFO's offset
        span = getattr(self.app.frontend, "effective_sr",
                       self.app.samplerate)
        off = bm["frequency"] - self.app.frequency
        if abs(off) < 0.5 * span - (bm.get("bandwidth") or 0.0) / 2:
            m.set_offset(off)
        else:
            self.app.tune(bm["frequency"] - m.offset_hz)
        if bm.get("mode") in DEMOD_IDS and \
                DEMOD_IDS[bm["mode"]] != m.demod_id:
            m.select_demod(DEMOD_IDS[bm["mode"]])
        if bm.get("bandwidth"):
            m.set_bandwidth(float(bm["bandwidth"]))
        return vfo

    # -- debug protocol (reference http surface) ------------------------
    def _bookmark_rows(self):
        return [{"name": n, **bm} for n, bm in self.bookmarks.items()]

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "get_lists":
            return {"status": "ok", "lists": sorted(self.lists)}
        if cmd == "get_current_list":
            return {"status": "ok", "current_list": self.current}
        if cmd == "set_current_list":
            name = args.strip()
            if name not in self.lists:
                return {"error": f"no list '{name}'"}
            self.current = name
            self._save()
            return {"status": "ok", "current_list": name}
        if cmd in ("get_bookmarks", "list"):
            if cmd == "list":                    # legacy shape
                return {"bookmarks": self.bookmarks}
            return {"status": "ok", "bookmarks": self._bookmark_rows()}
        if cmd == "add_bookmark":
            # "Name|frequency|bandwidth|mode[|vfo]" (reference protocol;
            # mode is a DemodID number or name)
            parts = [p.strip() for p in args.split("|")]
            if len(parts) < 2:
                return {"error": "usage: Name|freq[|bw|mode|vfo]"}
            try:
                freq = float(parts[1])
                bw = float(parts[2]) if len(parts) > 2 and parts[2] \
                    else None
            except ValueError as e:
                return {"error": f"bad bookmark: {e}"}
            mode = parts[3] if len(parts) > 3 else "NFM"
            if mode.isdigit():
                i = int(mode)
                mode = DEMOD_NAMES[i] if 0 <= i < len(DEMOD_NAMES) \
                    else "NFM"
            vfo = parts[4] if len(parts) > 4 else "Radio"
            self.add(parts[0], freq, mode, bw, vfo)
            return {"status": "ok", "name": parts[0]}
        if cmd == "add":
            try:
                j = json.loads(args)
                self.add(j["name"], j["frequency"], j.get("mode", "NFM"),
                         j.get("bandwidth"), j.get("vfo", "Radio"))
                return {"status": "ok"}
            except (json.JSONDecodeError, KeyError) as e:
                return {"error": f"bad bookmark: {e}"}
        if cmd in ("remove_bookmark", "remove"):
            return ({"status": "ok"} if self.remove(args.strip())
                    else {"error": f"no bookmark '{args}'"})
        if cmd == "apply_bookmark":
            vfo = self.apply(args.strip())
            return ({"status": "ok", "vfo": vfo} if vfo
                    else {"error": f"cannot apply '{args}'"})
        if cmd == "apply":
            parts = args.split(",")
            bm = parts[0].strip()
            vfo = parts[1].strip() if len(parts) > 1 else None
            got = self.apply(bm, vfo)
            return ({"status": "ok", "vfo": got} if got
                    else {"error": f"cannot apply '{args}'"})
        return super().handle_debug_command(cmd, args)
