"""Synchronous observer list (a copy of
sdrplusplusbrown_tpu/utils/event.py; reference core/src/utils/event.h:18-45)."""

from __future__ import annotations

from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class Event(Generic[T]):
    def __init__(self):
        self._handlers: List[Callable[[T], None]] = []

    def bind(self, handler: Callable[[T], None]):
        self._handlers.append(handler)

    def unbind(self, handler: Callable[[T], None]):
        if handler in self._handlers:
            self._handlers.remove(handler)

    def emit(self, value: T):
        for h in list(self._handlers):
            h(value)
