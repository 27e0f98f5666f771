"""A reader and writer for the flat YAML of `args.yaml` and `metadata.yaml`.

Those files are written by `yaml.safe_dump` of a flat dict: each line is
`key: scalar`, or `key:` followed by `- scalar` lines of a list. This reader
accepts exactly that and raises `ValueError` on anything else (nesting,
flow collections, anchors, multi-line strings). Scalars resolve as PyYAML's
safe loader resolves them for the forms these files hold: null, bool, int,
float (YAML 1.1: a dot is required, an exponent needs its sign) and str.

`dumps` writes a flat dict of such scalars and non-empty lists of them as
`yaml.safe_dump` does: keys sorted, list items as `- ` lines under their
key, floats as `repr` with `.0` put before a bare exponent, and a string
that would read back as another type single-quoted.
"""
from __future__ import annotations

import re
from typing import Any, Dict

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?: (.*))?$")
_ITEM = re.compile(r"^- (.*)$")
_SPECIAL = set("[]{}&*!|>%@`#")
_PLAIN = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")


def parse_scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        if "\\" in s:
            raise ValueError(f"flat yaml: escapes are not supported: {text!r}")
        return s[1:-1]
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if s.lstrip("+-") != "." and _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    if s[0] in _SPECIAL or s[0] in "'\"" or ": " in s or " #" in s:
        raise ValueError(f"flat yaml: unsupported scalar {text!r}")
    return s


def loads(text: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    list_key = None
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line or line == "---":
            continue
        m_item = _ITEM.match(line)
        if m_item:
            if list_key is None:
                raise ValueError(f"flat yaml line {n}: list item without a key")
            out[list_key].append(parse_scalar(m_item.group(1)))
            continue
        m_key = _KEY.match(line)
        if not m_key:
            raise ValueError(f"flat yaml line {n}: unsupported syntax {raw!r}")
        key, value = m_key.group(1), m_key.group(2)
        if key in out:
            raise ValueError(f"flat yaml line {n}: duplicate key {key!r}")
        if value is None or value.strip() == "":
            out[key] = []
            list_key = key
        else:
            out[key] = parse_scalar(value)
            list_key = None
    # A key with no items below it is YAML null.
    for k, v in out.items():
        if v == []:
            out[k] = None
    return out


def load_flat_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read())


def dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        if _PLAIN.match(value) and parse_scalar(value) == value:
            return value
        if "\n" in value:
            raise ValueError(f"flat yaml: multi-line strings are not supported: {value!r}")
        return "'" + value.replace("'", "''") + "'"
    raise ValueError(f"flat yaml: unsupported value {value!r}")


def dumps(data: Dict[str, Any]) -> str:
    lines = []
    for key in sorted(data):
        if not _KEY.match(f"{key}:"):
            raise ValueError(f"flat yaml: unsupported key {key!r}")
        value = data[key]
        if isinstance(value, (list, tuple)):
            if not value:
                raise ValueError(f"flat yaml: empty list under {key!r}")
            lines.append(f"{key}:")
            lines.extend(f"- {dump_scalar(v)}" for v in value)
        else:
            lines.append(f"{key}: {dump_scalar(value)}")
    return "".join(line + "\n" for line in lines)


def save_flat_yaml(path: str, data: Dict[str, Any]):
    with open(path, "w") as f:
        f.write(dumps(data))
