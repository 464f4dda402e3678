"""Typed signals (observer pattern) used for cross-layer upcalls.

The port's copy of ``simgrid_tpu/utils/signal.py``.

Equivalent of xbt::signal (reference: include/xbt/signal.hpp),
which SimGrid uses for every upward notification (e.g.
s4u::Link::on_communicate, Host::on_creation, Actor::on_termination).
Plugins subscribe to these without the core layers knowing about them.
"""

from __future__ import annotations

from typing import Callable, Generic, List, TypeVar

F = TypeVar("F", bound=Callable)


class Signal(Generic[F]):
    __slots__ = ("_slots",)

    def __init__(self) -> None:
        self._slots: List[Callable] = []

    def connect(self, fn: Callable) -> Callable:
        self._slots.append(fn)
        return fn

    def disconnect(self, fn: Callable) -> None:
        self._slots.remove(fn)

    def disconnect_all(self) -> None:
        self._slots.clear()

    def __call__(self, *args, **kwargs) -> None:
        for fn in list(self._slots):
            fn(*args, **kwargs)

    def __bool__(self) -> bool:
        return bool(self._slots)
