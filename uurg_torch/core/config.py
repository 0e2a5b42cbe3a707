"""Config system: YAML -> nested attribute namespace.

Port of ``uurg_tpu/core/config.py`` (same ``Config`` semantics, so the
reference YAML schemas such as ``configs/cifar10_sfron.yml`` load unchanged).
PyYAML is imported inside :func:`load_config` only: the model and sampling
path never need it.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping


class Config:
    """Nested attribute/dict-style config namespace.

    Supports ``cfg.model.ch`` and ``cfg["model"]["ch"]``, ``.get()`` with a
    default, and round-trips to plain dicts.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        # guard against recursion during deepcopy/pickle before _data exists
        if name.startswith("__") or name == "_data":
            raise AttributeError(name)
        try:
            data = object.__getattribute__(self, "_data")
        except AttributeError:
            raise AttributeError(name) from None
        try:
            return data[name]
        except KeyError:
            raise AttributeError(f"Config has no field {name!r}; "
                                 f"known: {sorted(data)}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = _wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v)
                for k, v in self._data.items()}

    def replace(self, **updates) -> "Config":
        new = copy.deepcopy(self)
        for k, v in updates.items():
            new[k] = v
        return new

    def merged(self, other: "Config | Mapping") -> "Config":
        """Deep-merge ``other`` over self, returning a new Config."""
        base = self.to_dict()
        upd = other.to_dict() if isinstance(other, Config) else dict(other)
        return Config(_deep_merge(base, upd))

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        return NotImplemented


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _deep_merge(base: dict, upd: dict) -> dict:
    out = dict(base)
    for k, v in upd.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> Config:
    """Load a YAML config file (reference schema compatible)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    cfg = Config(data)
    if overrides:
        cfg = cfg.merged(Config(dict(overrides)))
    return cfg
