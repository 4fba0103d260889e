"""Configuration system.

Same YAML schema as the reference (flat keys + one nested per-model section,
see reference/util/conf.py:5-28 and conf/*.yaml), with two upgrades the
reference lacks: dotted-key CLI overrides and a non-fatal ``get``. A missing
key accessed via ``__getitem__`` raises ``KeyError`` instead of hard-exiting
the interpreter (reference hard-exits at util/conf.py:12-13); callers that
want the reference's behaviour can catch it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional

import yaml


def _coerce(value: str) -> Any:
    """Best-effort typed coercion for CLI override strings."""
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    for caster in (int, float):
        try:
            return caster(value)
        except ValueError:
            continue
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1].strip()
        if not inner:
            return []
        return [_coerce(v.strip()) for v in inner.split(",")]
    return value


class ModelConf:
    """Dict-like model configuration loaded from YAML.

    Mirrors the access surface of the reference ``ModelConf``
    (``conf[key]`` / ``conf.contain(key)``) so configs written for the
    reference work unchanged.
    """

    def __init__(self, source: Any = None, overrides: Optional[Dict[str, Any]] = None):
        self.config: Dict[str, Any] = {}
        if isinstance(source, str):
            self.read_configuration(source)
        elif isinstance(source, dict):
            self.config = dict(source)
        elif source is not None:
            raise TypeError(f"ModelConf source must be a path or dict, got {type(source)}")
        if overrides:
            for key, value in overrides.items():
                self.set_dotted(key, value)

    # -- reference-compatible surface -------------------------------------
    def __getitem__(self, item: str) -> Any:
        if not self.contain(item):
            raise KeyError(f"Parameter {item!r} is not found in the configuration file!")
        return self.config[item]

    def contain(self, key: str) -> bool:
        return key in self.config

    def read_configuration(self, path: str) -> None:
        if not os.path.exists(path):
            raise IOError(f"Config file is not found: {path}")
        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if not isinstance(loaded, dict):
            raise IOError(f"Config file is not a YAML mapping: {path}")
        self.config = loaded

    # -- extended surface ---------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self.config.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.config

    def __iter__(self) -> Iterator[str]:
        return iter(self.config)

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        """Set ``a.b.c=value``. The reference YAML uses literal dotted keys at
        the top level (e.g. ``item.ranking.topN``), so a dotted override first
        matches an existing literal key; only otherwise does it descend into
        nested mappings (e.g. ``SimGCL.lambda``)."""
        if isinstance(value, str):
            value = _coerce(value)
        if dotted_key in self.config:
            self.config[dotted_key] = value
            return
        parts = dotted_key.split(".")
        # descend into EXISTING nested mappings (model sections like
        # ``SimGCL.lambda``) and KNOWN section names even when absent
        # (``--set mesh.data=4`` must create the mesh section, not a literal
        # top-level key); otherwise the reference schema treats dotted names
        # as literal top-level keys (``checkpoint.dir``, ``max.len``).
        known_sections = {"model", "mesh"}
        model_name = self.config.get("model", {})
        if isinstance(model_name, dict) and model_name.get("name"):
            known_sections.add(model_name["name"])
        if len(parts) > 1 and (
            isinstance(self.config.get(parts[0]), dict)
            or parts[0] in known_sections
        ):
            node = self.config
            for part in parts[:-1]:
                if not isinstance(node.get(part), dict):
                    node[part] = {}
                node = node[part]
            node[parts[-1]] = value
        else:
            self.config[dotted_key] = value

    def model_args(self) -> Dict[str, Any]:
        """The per-model nested section, e.g. config['SimGCL']."""
        name = self.config.get("model", {}).get("name")
        section = self.config.get(name, {}) if name else {}
        return section if isinstance(section, dict) else {}

    def __repr__(self) -> str:
        return f"ModelConf({self.config!r})"
