"""The port's own reader and writer for the YAML subset of ``VioOptions``.

PyYAML is not a dependency of the port (the card's machine has none), so
``VioOptions.from_yaml`` / ``to_yaml`` go through this module always. It
handles one flat mapping of:

- ``key: value`` lines at the top level (keys are identifiers);
- scalars: int, float (``.inf``, ``-.inf``, ``.nan`` included),
  ``true`` / ``false``, ``null``, and plain or quoted strings;
- block lists of scalars, and block lists of block lists (a matrix such
  as ``t_imu_to_cam``);
- comments and blank lines.

``dump`` writes byte for byte what ``yaml.safe_dump(data,
sort_keys=False)`` writes for such a mapping (PyYAML's float spelling
``1.0e-05`` included). Scalars resolve as in PyYAML (YAML 1.1): a plain
``yes`` is true and a plain ``1e-5`` is no float there, so ``load``
refuses the plain scalars that PyYAML would read as something other than
their look (exponents without a dot, octal, sexagesimal and hex integers,
underscores, dates). Anything outside the subset (flow collections,
anchors, tags, multi-line strings, nested mappings, ...) raises a
``YamlSubsetError`` that names the line; nothing is misread silently.
"""

from __future__ import annotations

import math
import re

__all__ = ["YamlSubsetError", "dump", "load"]

WIDTH = 80  # PyYAML's best_width: longer plain or quoted strings may wrap


class YamlSubsetError(ValueError):
    """Input or data outside the YAML subset this module handles."""


# YAML 1.1 implicit resolvers, as PyYAML applies them to plain scalars
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_OTHER = re.compile(r"^(?:<<|=)$")  # merge and value keys
# the forms of those that this module reads
_DEC_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_DEC_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?: |$)")


def _implicit(text: str) -> bool:
    """Whether PyYAML reads the plain scalar ``text`` as something other
    than a string."""
    return any(r.match(text) for r in (_BOOL, _FLOAT, _INT, _NULL, _TIMESTAMP, _OTHER))


def _number_like(text: str) -> bool:
    """Whether Python reads ``text`` as a number (``1e-5``, ``inf``, ...)."""
    try:
        float(text)
    except ValueError:
        return False
    return True


# ------------------------------------------------------------------ writer
def _float(x: float) -> str:
    """PyYAML's ``represent_float``."""
    if x != x:
        return ".nan"
    if x == math.inf:
        return ".inf"
    if x == -math.inf:
        return "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _plain_ok(s: str) -> bool:
    """PyYAML's block-plain analysis for printable ASCII on one line."""
    if s[0] in " " or s[-1] == " " or s.startswith(("---", "...")):
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if s[0] in "?:-" and (len(s) == 1 or s[1] == " "):
        return False
    return ": " not in s and not s.endswith(":") and " #" not in s


def _string(s: str, column: int) -> str:
    if any(not (" " <= ch <= "~") for ch in s):
        raise YamlSubsetError(f"string {s!r}: only printable ASCII on one line is written")
    if _number_like(s) and not _implicit(s):
        raise YamlSubsetError(f"string {s!r}: PyYAML writes it plain, and it reads as a number")
    if s and _plain_ok(s) and not _implicit(s):
        text = s
    else:
        text = "'" + s.replace("'", "''") + "'"
    if " " in s and column + len(text) > WIDTH:
        raise YamlSubsetError(f"string {s!r}: a line over {WIDTH} columns would wrap")
    return text


def _scalar(x, column: int) -> str:
    if x is None:
        return "null"
    if type(x) is bool:
        return "true" if x else "false"
    if type(x) is int:
        return str(x)
    if type(x) is float:
        return _float(x)
    if type(x) is str:
        return _string(x, column)
    raise YamlSubsetError(f"cannot write a {type(x).__name__} ({x!r}) as a YAML scalar")


def _items(values: list, indent: int, lines: list, first_prefix: str) -> None:
    """Block-list items at ``indent``; the first one continues the line
    ``first_prefix`` (a nested list's ``- - ``)."""
    for i, v in enumerate(values):
        prefix = first_prefix if i == 0 else " " * indent + "- "
        if type(v) is list:
            if not v:
                raise YamlSubsetError("an empty list needs a flow collection")
            _items(v, indent + 2, lines, prefix + "- ")
        else:
            lines.append(prefix + _scalar(v, len(prefix)))


def dump(data: dict) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` for a flat mapping of the
    subset's scalars and (nested) lists of them."""
    lines = []
    for key, value in data.items():
        if type(key) is not str or not _KEY.match(key + ":"):
            raise YamlSubsetError(f"key {key!r} is not an identifier")
        if type(value) is list:
            if not value:
                raise YamlSubsetError(f"{key}: an empty list needs a flow collection")
            lines.append(f"{key}:")
            _items(value, 0, lines, "- ")
        elif type(value) is dict:
            raise YamlSubsetError(f"{key}: nested mappings are outside the subset")
        else:
            lines.append(f"{key}: {_scalar(value, len(key) + 2)}")
    return "\n".join(lines) + "\n" if lines else "{}\n"


# ------------------------------------------------------------------ reader
def _strip_comment(text: str) -> str:
    """``text`` up to a `` #`` comment (plain scalars only)."""
    cut = text.find(" #")
    return (text if cut < 0 else text[:cut]).rstrip()


def _quoted(text: str, where: str) -> str:
    quote = text[0]
    i, out = 1, []
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            break
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in ('"', "\\"):
                raise YamlSubsetError(f"{where}: escape \\{esc} is outside the subset")
            out.append(esc)
            i += 2
            continue
        if quote == '"' and ch == '"':
            break
        out.append(ch)
        i += 1
    else:
        raise YamlSubsetError(f"{where}: unterminated quoted string (multi-line strings "
                              "are outside the subset)")
    rest = text[i + 1:].strip()
    if rest and not rest.startswith("#"):
        raise YamlSubsetError(f"{where}: text after a quoted string")
    return "".join(out)


def _parse_scalar(text: str, where: str):
    """One scalar (quoted or plain, comment stripped) as PyYAML reads it."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text, where)
    text = _strip_comment(text)
    if text[:1] in tuple("[]{}&*!|>%@`,") or text.startswith(("? ", ": ", "- ")) or text in (
            "?", ":", "-"):
        raise YamlSubsetError(f"{where}: {text!r} is outside the subset (flow collections, "
                              "anchors, aliases, tags, block scalars, nested blocks)")
    if ": " in text or text.endswith(":"):
        raise YamlSubsetError(f"{where}: nested mappings are outside the subset")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _DEC_INT.match(text):
        return int(text)
    if _DEC_FLOAT.match(text):
        return float(text)
    low = text.lower()
    if low in (".inf", "+.inf", "-.inf", ".nan") and _FLOAT.match(text):
        return -math.inf if low.startswith("-") else (math.nan if "nan" in low else math.inf)
    if _implicit(text) or _number_like(text):
        raise YamlSubsetError(
            f"{where}: {text!r} is outside the subset (YAML 1.1 reads it as another type "
            "than it looks, or not as a number; write decimals, with a dot before any "
            "exponent: 1.0e-05)")
    return text


def _lines(text: str):
    """(line number, indent, content) of each line that holds data."""
    for n, raw in enumerate(text.splitlines(), 1):
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        body = raw.rstrip()
        indent = len(body) - len(body.lstrip(" "))
        if "\t" in body[:indent + 1]:
            raise YamlSubsetError(f"line {n}: tab indentation")
        if indent == 0 and body.startswith(("---", "...", "%")):
            raise YamlSubsetError(f"line {n}: documents and directives are outside the subset")
        yield n, indent, body[indent:]


def _parse_list(lines: list, pos: int, indent: int):
    """The block list whose items start at ``indent`` from ``lines[pos]``.
    Returns (values, next position)."""
    values = []
    while pos < len(lines):
        n, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"line {n}: unexpected indentation")
        if not (content == "-" or content.startswith("- ")):
            if indent == 0:
                break  # the next key
            raise YamlSubsetError(f"line {n}: expected a list item")
        rest = content[1:]
        item = rest.strip()
        if not item or item.startswith("#"):  # the item's list on the next lines
            if pos + 1 >= len(lines) or lines[pos + 1][1] <= indent:
                values.append(None)
                pos += 1
            else:
                nested, pos = _parse_list(lines, pos + 1, lines[pos + 1][1])
                values.append(nested)
        elif item == "-" or item.startswith("- "):  # '- - x': a nested list inline
            inner = indent + 1 + (len(rest) - len(rest.lstrip(" ")))
            lines[pos] = (n, inner, item)
            nested, pos = _parse_list(lines, pos, inner)
            values.append(nested)
        else:
            values.append(_parse_scalar(item, f"line {n}"))
            pos += 1
    return values, pos


def load(text: str) -> dict:
    """The flat mapping of a YAML text in the subset (``{}`` when empty)."""
    lines = list(_lines(text))
    data, pos = {}, 0
    if len(lines) == 1 and lines[0][2] == "{}":
        return data
    while pos < len(lines):
        n, indent, content = lines[pos]
        if indent:
            raise YamlSubsetError(f"line {n}: unexpected indentation")
        m = _KEY.match(content)
        if not m:
            raise YamlSubsetError(f"line {n}: expected 'key: value' (a plain identifier key)")
        key = m.group(1)
        if key in data:
            raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
        rest = content[m.end():].strip()
        pos += 1
        if rest and not rest.startswith("#"):
            data[key] = _parse_scalar(rest, f"line {n}")
        elif pos < len(lines) and (lines[pos][1] > 0 or lines[pos][2] == "-"
                                   or lines[pos][2].startswith("- ")):
            data[key], pos = _parse_list(lines, pos, lines[pos][1])
        else:
            data[key] = None
    return data
