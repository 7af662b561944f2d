"""Config loading: YAML with attribute access (the configs/*.yaml schema).

Counterpart of vision_kit_tpu/utils/config.py: nested dicts become
ConfigNode with dot and item access; lists stay lists; save_config writes
one back as YAML.
"""

from __future__ import annotations

from typing import Any

import yaml


class ConfigNode(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def load_config(path: str) -> ConfigNode:
    with open(path) as f:
        return ConfigNode.wrap(yaml.safe_load(f))


def save_config(cfg: ConfigNode, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)
