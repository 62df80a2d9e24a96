"""Environment parsing shared by the modules that read flags."""

from __future__ import annotations


def _flag(env, name: str, default: bool = False) -> bool:
    raw = env.get(name)
    if raw is None:
        return default
    return raw.lower() in ("true", "1", "on", "enabled")
