"""Python-file configs with ``_base_`` inheritance and ``key=value``
overrides (the port's own copy of dtlr_tpu/config/loader.py).

A config is an executable ``.py`` file; its module-level names, minus
dunders, callables and modules, are its keys. ``_base_ = [...]`` names
files (relative to it) merged first, recursively; a nested dict with
``_delete_: True`` replaces its base's instead of merging into it.
``dump_config`` writes a config back as such a file, one sorted
``key = pprint(value)`` line each, which ``load_config`` reads back.
"""

from __future__ import annotations

import ast
import copy
import os
import pprint
import runpy
from typing import Any, Dict, Iterable

_RESERVED = ("_base_", "_delete_")


class Config(dict):
    """A dict with attribute access; nested dicts are wrapped on access."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))

    def get_default(self, name: str, default: Any = None) -> Any:
        return self[name] if name in self else default


def _exec_py_config(path: str) -> Dict[str, Any]:
    ns = runpy.run_path(path)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))}


def _merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """``override`` merged into ``base`` recursively (``override`` wins)."""
    out = dict(base)
    for key, value in override.items():
        if (isinstance(value, dict) and isinstance(out.get(key), dict)
                and not value.get("_delete_", False)):
            out[key] = _merge(out[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != "_delete_"}
            out[key] = value
    return out


def load_config(path: str) -> Config:
    """A ``.py`` config file with its ``_base_`` files resolved."""
    path = os.path.abspath(path)
    raw = _exec_py_config(path)
    bases = raw.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base_rel in bases:
        merged = _merge(merged, load_config(os.path.join(os.path.dirname(path), base_rel)))
    merged = _merge(merged, raw)
    for key in _RESERVED:
        merged.pop(key, None)
    return Config(merged)


def dump_config(cfg: Dict[str, Any], path: str) -> None:
    """Write a config back out as an executable ``.py`` file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("# auto-dumped config (dtlr_tpu)\n")
        for key in sorted(cfg):
            fh.write(f"{key} = {pprint.pformat(cfg[key], width=100)}\n")


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return text


def parse_options(pairs: Iterable[str] | None) -> Dict[str, Any]:
    """``key=value`` override pairs as a (nested, for dotted keys) dict;
    values are Python literals where they parse as one, else strings."""
    out: Dict[str, Any] = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise ValueError(f"--options entries must be key=value, got {pair!r}")
        key, _, value = pair.partition("=")
        node = out
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_value(value)
    return out


def apply_options(cfg: Config, options: Dict[str, Any]) -> Config:
    return Config(_merge(cfg, options))
