"""Two-file YAML configs (the port's own copy of ``enarf_gan_tpu/config.py``).

A fully populated default config and a sparse override, merged leaf-wise
(the override wins), as an attribute-access dict. The files are read by
``load_yaml``, a reader of the YAML subset that ``configs/`` uses, without
PyYAML (the GPU machine has none): block mappings by indentation, ``#``
comments, and plain or quoted scalars resolved as PyYAML's ``safe_load``
resolves them (null, true/false, decimal int, float, string; so ``1e-3``,
which has no dot, stays a string, as there). Anything else raises
``YAMLSubsetError`` with the line number: sequences, flow collections,
anchors, tags, block scalars, multi-line scalars, quoted keys, escapes, and
the scalars PyYAML would read as yes/no/on/off, inf, nan, octal, hex,
base 60 or dates.
"""
from __future__ import annotations

import copy
import re
from typing import Any, Mapping, Optional, Tuple


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


class YAMLSubsetError(ValueError):
    """A YAML construct outside the subset ``load_yaml`` reads."""

    def __init__(self, source: str, line: int, message: str):
        super().__init__(f"{source}, line {line}: {message}")
        self.line = line


# PyYAML's implicit resolvers (YAML 1.1) for the scalars of the subset, and
# the forms it resolves that the subset refuses
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_OUTSIDE = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"               # bools
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"                   # floats
    r"|[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"          # ints
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"           # base 60
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|=|<<)$")                    # dates
_INDICATORS = "[]{},&*!|>%@`\"'"


def _plain_scalar(text: str, err):
    """A plain scalar as PyYAML's safe_load resolves it."""
    if text[:1] and (text[0] in _INDICATORS or text[:2] in ("- ", "? ", ": ")
                     or text in ("-", "?")):
        err(f"{text!r} starts with an indicator outside the subset")
    if ": " in text or text.endswith(":") or " #" in text:
        err(f"{text!r} is not a scalar of the subset")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OUTSIDE.match(text):
        err(f"{text!r} resolves to a form outside the subset")
    return text


def _quoted(text: str, err) -> Tuple[str, str]:
    """The quoted scalar at the start of ``text`` (no escapes) and what
    follows it."""
    end = text.find(text[0], 1)
    if end < 0:
        err(f"unterminated quoted scalar {text!r} (multi-line scalars are "
            f"outside the subset)")
    value = text[1:end]
    if "\\" in value and text[0] == '"':
        err(f"escapes in {text!r} are outside the subset")
    return value, text[end + 1:]


def _after_quoted(rest: str, err) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        err(f"{rest!r} after a quoted scalar")


def _split_line(body: str, err) -> Tuple[Any, str]:
    """``key: value`` → (key, the value's text without its comment, or
    ("quoted", value))."""
    colon = re.search(r":(?: |$)", body)
    if colon is None or " #" in body[:colon.start()]:
        err(f"{body!r} is not a 'key: value' line (sequences and bare "
            f"scalars are outside the subset)")
    key = _plain_scalar(body[:colon.start()].rstrip(), err)
    rest = body[colon.end():].strip(" ")
    if rest.startswith("#"):
        return key, ""
    if rest[:1] in ("\"", "'"):
        value, after = _quoted(rest, err)
        _after_quoted(after, err)
        return key, ("quoted", value)
    comment = re.search(r"[ \t]#", rest)
    return key, rest[:comment.start()].rstrip() if comment else rest


def load_yaml(text: str, source: str = "<string>") -> Any:
    """The YAML document ``text`` (nested block mappings of scalars) as
    dicts, as PyYAML's ``safe_load`` reads it; None for an empty one."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        stripped = raw.lstrip(" ")
        if not stripped.strip() or stripped.startswith("#"):
            continue
        if stripped[0] == "\t":
            raise YAMLSubsetError(source, no, "tabs may not indent")
        if raw.startswith(("---", "...", "%")):
            raise YAMLSubsetError(source, no, "document markers and "
                                  "directives are outside the subset")
        lines.append((no, len(raw) - len(stripped), stripped.rstrip()))

    def mapping(i: int, indent: int):
        out = {}
        while i < len(lines) and lines[i][1] >= indent:
            no, ind, body = lines[i]

            def err(message, no=no):
                raise YAMLSubsetError(source, no, message)

            if ind > indent:
                err("indented deeper than its mapping's keys")
            key, value = _split_line(body, err)
            i += 1
            deeper = i < len(lines) and lines[i][1] > indent
            if isinstance(value, tuple):
                value = value[1]
                if deeper:
                    err("a scalar continued on the next line")
            elif value == "":
                if deeper:
                    value, i = mapping(i, lines[i][1])
                else:
                    value = None
            else:
                if deeper:
                    err("a scalar continued on the next line")
                value = _plain_scalar(value, err)
            out[key] = value
        return out, i

    if not lines:
        return None
    root, i = mapping(0, lines[0][1])
    if i < len(lines):
        raise YAMLSubsetError(source, lines[i][0], "indented less than the "
                              "document's first key")
    return root


def read_yaml(path: str) -> Any:
    with open(path) as f:
        return load_yaml(f.read(), path)


def yaml_config(config: str, default_config: str, resume_latest: bool = False,
                num_workers: int = 1) -> AttrDict:
    """Load the default and override YAML files and merge them."""
    default = read_yaml(default_config) or {}
    conf = read_yaml(config) or {}
    merged = merge_config(conf, default)
    merged["resume_latest"] = resume_latest
    if "dataset" in merged and isinstance(merged["dataset"], AttrDict):
        merged["dataset"]["num_workers"] = num_workers
    return merged
