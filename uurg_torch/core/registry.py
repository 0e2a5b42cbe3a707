"""Explicit name->factory registries.

This package's own copy of ``uurg_tpu/core/registry.py``. The reference resolves names with ``eval(name)`` (Classification/unlearn/
__init__.py:11-12, models/__init__.py:5-6, dataset/__init__.py:7-9). We use
explicit registries instead: no arbitrary code execution, and discoverable
listings for error messages.
"""
from __future__ import annotations

from typing import Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str, obj: T | None = None):
        """Register an object, or use as a decorator: ``@reg.register("x")``."""
        if obj is not None:
            self._entries[name] = obj
            return obj

        def deco(fn: T) -> T:
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} {name!r}; available: {sorted(self._entries)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def names(self):
        return sorted(self._entries)
