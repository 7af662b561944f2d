"""Config loading: YAML with attribute access (the configs/*.yaml schema).

Counterpart of vision_kit_tpu/utils/config.py: nested dicts become
ConfigNode with dot and item access; lists stay lists.
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


def load_config(path: str) -> ConfigNode:
    with open(path) as f:
        return ConfigNode.wrap(yaml.safe_load(f))
