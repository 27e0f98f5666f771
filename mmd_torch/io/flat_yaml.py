"""A reader and writer for the flat YAML of `args.yaml`, `metadata.yaml`
and `MODEL_EVAL.yaml`.

The first two are written by `yaml.safe_dump` of a flat dict: each line is
`key: scalar`, or `key:` followed by `- scalar` lines of a list. The third
is a top-level list of flat mappings (`- key: scalar` then `  key: scalar`
lines). `loads` and `loads_rows` accept exactly these and raise
`ValueError` on anything else (nesting, flow collections, anchors, block
scalars). A long scalar may continue on more deeply indented lines, each
line break read as one space, as PyYAML folds it. Scalars resolve as
PyYAML's safe loader resolves them for the forms these files hold: null,
bool, int, float (YAML 1.1: a dot is required, an exponent needs its sign)
and str.

`dumps` and `dumps_rows` write the same shapes as `yaml.safe_dump` does:
keys sorted, list items as `- ` lines under their key, floats as `repr`
with `.0` put before a bare exponent, a string plain where PyYAML's emitter
allows it and single-quoted where it would read back as another type or
holds an indicator, and a line broken at a space once it passes 80
columns.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

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
# Plain strings that PyYAML's resolver would read as another type than the
# reader above knows: other ints, sexagesimals, timestamps, '=' and '<<'.
_OTHER_TYPES = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*|=|<<)$")
_WIDTH = 80  # PyYAML's best_width


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


def _logical_lines(text: str, indent: int):
    """(line number, line) of `text` with blank lines and the document
    marker dropped, and each line indented by more than `indent` spaces
    (a folded scalar's continuation) joined to the one before it with a
    space."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line or line == "---":
            continue
        depth = len(line) - len(line.lstrip(" "))
        if depth > indent and not line.lstrip().startswith("- "):
            rest = line.strip()
            m = _KEY.match(out[-1][1].removeprefix("- ").lstrip(" ")) if out else None
            value = (m.group(2) or "") if m else ""
            # Inside an open single-quoted scalar any text continues it (its
            # quotes come in pairs until the closing one).
            quoted = value.startswith("'") and value.count("'") % 2 == 1
            if not value or not quoted and (
                    ": " in rest or " #" in rest or rest[0] in _SPECIAL):
                raise ValueError(f"flat yaml line {n}: unsupported syntax {raw!r}")
            out[-1] = (out[-1][0], out[-1][1] + " " + rest)
            continue
        out.append((n, line))
    return out


def _mapping(lines, allow_lists: bool) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    list_key = None
    for n, line in lines:
        m_item = _ITEM.match(line)
        if m_item:
            if list_key is None or not allow_lists:
                raise ValueError(f"flat yaml line {n}: list item without a key")
            out[list_key].append(parse_scalar(m_item.group(1)))
            continue
        m_key = _KEY.match(line)
        if not m_key:
            raise ValueError(f"flat yaml line {n}: unsupported syntax {line!r}")
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


def loads(text: str) -> Dict[str, Any]:
    return _mapping(_logical_lines(text, 0), allow_lists=True)


def loads_rows(text: str) -> List[Dict[str, Any]]:
    """A top-level list of flat mappings of scalars; [] for an empty
    document, as `yaml.safe_load(...) or []` gives."""
    if text.strip() == "[]":
        return []
    rows: List[list] = []
    for n, line in _logical_lines(text, 2):
        if line.startswith("- "):
            rows.append([(n, line[2:])])
        elif line.startswith("  ") and rows and not line[2:].startswith(" "):
            rows[-1].append((n, line[2:]))
        else:
            raise ValueError(f"flat yaml line {n}: not a list of flat mappings: {line!r}")
    return [_mapping(r, allow_lists=False) for r in rows]


def load_flat_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read())


def load_rows(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return loads_rows(f.read())


def _plain_allowed(text: str) -> bool:
    """PyYAML's emitter's analysis of a scalar (`analyze_scalar`): may it
    be written plain in block context? Only printable ASCII is handled."""
    if not text or text.startswith(("---", "...")) or text[0] == " " or text[-1] == " ":
        return False
    for i, ch in enumerate(text):
        if not " " <= ch <= "~":
            return False
        before_ws = i == 0 or text[i - 1] == " "
        after_ws = i + 1 >= len(text) or text[i + 1] == " "
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and after_ws):
                return False
        elif (ch == ":" and after_ws) or (ch == "#" and before_ws):
            return False
    return True


def _reads_back(text: str) -> bool:
    """Would `yaml.safe_load` read `text`, written plain, as this str?"""
    if _OTHER_TYPES.match(text):
        return False
    try:
        return parse_scalar(text) == text
    except ValueError:
        return False


def _emit(text: str, column: int, indent: int, quoted: bool) -> str:
    """`text` as PyYAML's `write_plain` / `write_single_quoted` write it
    from `column`: after an indicator, one space (and the quote); a single
    space between words becomes a line break and `indent` spaces once the
    line has passed 80 columns (never the first or last space of a quoted
    scalar)."""
    out = [" '" if quoted else " "]
    column += len(out[0])
    spaces, start, end = False, 0, 0
    while end <= len(text):
        ch = text[end] if end < len(text) else None
        if spaces:
            if ch != " ":
                edge_ok = not quoted or (start != 0 and end != len(text))
                if start + 1 == end and column > _WIDTH and edge_ok:
                    out.append("\n" + " " * indent)
                    column = indent
                else:
                    out.append(text[start:end])
                    column += end - start
                start = end
        elif ch is None or ch == " " or (quoted and ch == "'"):
            if start < end:
                out.append(text[start:end])
                column += end - start
                start = end
        if quoted and ch == "'":
            out.append("''")
            column += 2
            start = end + 1
        if ch is not None:
            spaces = ch == " "
        end += 1
    if quoted:
        out.append("'")
    return "".join(out)


def _line(prefix: str, value: Any, indent: int) -> str:
    """`prefix` (ending in `key:` or `-`) and its scalar value, folded as
    PyYAML folds a long string, continuation lines at `indent`."""
    if isinstance(value, str):
        if "\n" in value:
            raise ValueError(f"flat yaml: multi-line strings are not supported: {value!r}")
        plain = _plain_allowed(value) and _reads_back(value)
        if not plain and not all(" " <= ch <= "~" for ch in value):
            raise ValueError(f"flat yaml: unsupported string {value!r}")
        return prefix + _emit(value, len(prefix), indent, quoted=not plain)
    return f"{prefix} {dump_scalar(value)}"


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
        return _line("", value, 0)[1:]
    raise ValueError(f"flat yaml: unsupported value {value!r}")


def _mapping_lines(data: Dict[str, Any], first: str, rest: str, lists: bool) -> List[str]:
    """A flat mapping's lines: the first key after `first`, the others
    after `rest`; a folded value continues 2 spaces deeper than its key."""
    if not isinstance(data, dict) or not data:
        raise ValueError(f"flat yaml: not a non-empty flat mapping: {data!r}")
    lines = []
    for n, key in enumerate(sorted(data)):
        if not isinstance(key, str) or not _KEY.match(f"{key}:"):
            raise ValueError(f"flat yaml: unsupported key {key!r}")
        prefix = (first if n == 0 else rest) + f"{key}:"
        value = data[key]
        if isinstance(value, (list, tuple)):
            if not lists or not value:
                raise ValueError(f"flat yaml: unsupported list under {key!r}")
            lines.append(prefix)
            lines.extend(_line(rest + "-", v, len(rest) + 2) for v in value)
        elif isinstance(value, dict):
            raise ValueError(f"flat yaml: nested mapping under {key!r}")
        else:
            lines.append(_line(prefix, value, len(rest) + 2))
    return lines


def dumps(data: Dict[str, Any]) -> str:
    return "".join(line + "\n" for line in _mapping_lines(data, "", "", lists=True))


def dumps_rows(rows: List[Dict[str, Any]]) -> str:
    """A list of flat mappings of scalars, as `yaml.safe_dump(rows)`."""
    if not rows:
        return "[]\n"
    lines = []
    for row in rows:
        lines.extend(_mapping_lines(row, "- ", "  ", lists=False))
    return "".join(line + "\n" for line in lines)


def save_flat_yaml(path: str, data: Dict[str, Any]):
    with open(path, "w") as f:
        f.write(dumps(data))


def save_rows(path: str, rows: List[Dict[str, Any]]):
    with open(path, "w") as f:
        f.write(dumps_rows(rows))
