"""O(1) intrusive doubly-linked lists with deterministic ordering.

Python equivalent of the boost::intrusive lists the reference uses for every
kernel collection (e.g. maxmin.hpp element sets, Action state sets): the
push_front/push_back ordering defines deterministic iteration — and hence
event — order, so list membership lives on the objects themselves via a
per-list hook attribute.
"""

from __future__ import annotations

from typing import Any


class IntrusiveList:
    __slots__ = ("hook", "head", "tail", "size")

    def __init__(self, hook: str):
        self.hook = hook
        self.head: Any = None
        self.tail: Any = None
        self.size = 0

    def is_linked(self, obj) -> bool:
        return getattr(obj, self.hook, None) is not None

    def push_front(self, obj) -> None:
        assert getattr(obj, self.hook, None) is None
        setattr(obj, self.hook, [None, self.head])
        if self.head is not None:
            getattr(self.head, self.hook)[0] = obj
        else:
            self.tail = obj
        self.head = obj
        self.size += 1

    def push_back(self, obj) -> None:
        assert getattr(obj, self.hook, None) is None
        setattr(obj, self.hook, [self.tail, None])
        if self.tail is not None:
            getattr(self.tail, self.hook)[1] = obj
        else:
            self.head = obj
        self.tail = obj
        self.size += 1

    def remove(self, obj) -> None:
        prev, nxt = getattr(obj, self.hook)
        if prev is not None:
            getattr(prev, self.hook)[1] = nxt
        else:
            self.head = nxt
        if nxt is not None:
            getattr(nxt, self.hook)[0] = prev
        else:
            self.tail = prev
        setattr(obj, self.hook, None)
        self.size -= 1

    def pop_front(self):
        obj = self.head
        if obj is not None:
            self.remove(obj)
        return obj

    def front(self):
        return self.head

    def empty(self) -> bool:
        return self.head is None

    def __len__(self) -> int:
        return self.size

    def __iter__(self):
        # Safe against removal of the CURRENT node (the successor is
        # captured before yielding) — the same guarantee the
        # reference's ++it-before-erase idiom gives, so per-advance
        # model sweeps can traverse the live list directly instead of
        # paying an O(n) list(...) copy per advance.  Removing the
        # *successor* mid-iteration is not supported (same as the
        # reference).
        node = self.head
        while node is not None:
            nxt = getattr(node, self.hook)[1]
            yield node
            node = nxt

    def clear(self) -> None:
        node = self.head
        while node is not None:
            nxt = getattr(node, self.hook)[1]
            setattr(node, self.hook, None)
            node = nxt
        self.head = self.tail = None
        self.size = 0
