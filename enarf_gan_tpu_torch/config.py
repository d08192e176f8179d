"""Two-file YAML configs (the port's own copy of ``enarf_gan_tpu/config.py``).

A fully populated default config and a sparse override, merged leaf-wise
(the override wins), as an attribute-access dict. ``yaml`` is imported only
by ``yaml_config``, so importing the port never needs it.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping, Optional


class AttrDict(dict):
    """Attribute-access dict; nested mappings become AttrDicts."""

    def __init__(self, d: Optional[Mapping[str, Any]] = None, **kwargs):
        super().__init__()
        merged = dict(d or {})
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, Mapping) and not isinstance(v, AttrDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def merge_config(override: Mapping, default: Mapping) -> AttrDict:
    """Merge ``override`` into ``default``: a key whose default is a dict is
    descended into, any other key is replaced whole."""
    result = AttrDict(copy.deepcopy(dict(default)))
    for key, value in override.items():
        if key in result and isinstance(result[key], AttrDict) \
                and isinstance(value, Mapping):
            result[key] = merge_config(value, result[key])
        else:
            result[key] = value
    return result


def yaml_config(config: str, default_config: str, resume_latest: bool = False,
                num_workers: int = 1) -> AttrDict:
    """Load the default and override YAML files and merge them."""
    import yaml
    with open(default_config) as f:
        default = yaml.safe_load(f) or {}
    with open(config) as f:
        conf = yaml.safe_load(f) or {}
    merged = merge_config(conf, default)
    merged["resume_latest"] = resume_latest
    if "dataset" in merged and isinstance(merged["dataset"], AttrDict):
        merged["dataset"]["num_workers"] = num_workers
    return merged
