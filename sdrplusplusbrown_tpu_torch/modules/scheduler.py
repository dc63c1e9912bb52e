"""Scheduler — timed execution of module commands (counterpart of
sdrplusplusbrown_tpu/modules/scheduler.py).

reference: misc_modules/scheduler — schedules SDR/recorder actions (start
or stop at given times).  Tasks target any module's debug-command surface:
{"at": epoch_seconds | "in": delta_seconds, "module": name,
 "cmd": command, "args": string}.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List

from ..app import ModuleInstance
from ..utils.flog import flog


class SchedulerModule(ModuleInstance):
    def __init__(self, name: str, app):
        super().__init__(name)
        self.app = app
        self.tasks: List[Dict] = []
        self._next_id = 1
        self._mtx = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def module_type(self) -> str:
        return "scheduler"

    def _worker(self):
        while not self._stop.wait(0.25):
            now = time.time()
            due = []
            with self._mtx:
                for t in list(self.tasks):
                    if t["at"] <= now:
                        due.append(t)
                        self.tasks.remove(t)
            for t in due:
                m = self.app.modules.get(t["module"])
                if m is None:
                    flog.warn("scheduler[{}]: module '{}' missing",
                              self.name, t["module"])
                    continue
                r = m.handle_debug_command(t["cmd"], t.get("args", ""))
                flog.info("scheduler[{}]: ran {}.{} -> {}", self.name,
                          t["module"], t["cmd"], json.dumps(r)[:120])

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=3)

    def handle_debug_command(self, cmd: str, args: str) -> dict:
        if cmd == "add":
            try:
                j = json.loads(args)
                at = float(j["at"]) if "at" in j \
                    else time.time() + float(j["in"])
                with self._mtx:
                    task = {"id": self._next_id, "at": at,
                            "module": j["module"], "cmd": j["cmd"],
                            "args": str(j.get("args", ""))}
                    self.tasks.append(task)
                    self._next_id += 1
                return {"status": "ok", "id": task["id"], "at": at}
            except (json.JSONDecodeError, KeyError, ValueError) as e:
                return {"error": f"bad task: {e}"}
        if cmd == "list":
            with self._mtx:
                return {"tasks": [dict(t) for t in self.tasks]}
        if cmd == "remove":
            try:
                tid = int(args)
            except ValueError:
                return {"error": f"bad id '{args}'"}
            with self._mtx:
                n0 = len(self.tasks)
                self.tasks = [t for t in self.tasks if t["id"] != tid]
                if len(self.tasks) < n0:
                    return {"status": "ok"}
            return {"error": f"no task {tid}"}
        return super().handle_debug_command(cmd, args)
