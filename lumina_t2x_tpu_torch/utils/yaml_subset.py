"""A reader of the block-YAML subset the repo's settings and data manifests
use (`configs/infer/settings.yaml`, `configs/data/*.yaml`), so that no YAML
package is needed: nested block mappings and sequences of scalars, `#`
comments, PyYAML's plain-scalar resolution."""

from __future__ import annotations

import json
import re

# YAML 1.1 plain-scalar resolution, as PyYAML's SafeLoader does it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _scalar(text: str):
    """A YAML scalar: quoted string, null, bool, decimal int, float, else
    the plain string (flow collections are not read)."""
    if text[:1] in ("[", "{", "&", "*", "!", "|", ">"):
        raise ValueError(f"not in the YAML subset read here: {text!r}")
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)  # JSON's escapes are a subset of YAML's
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (at the line start or after whitespace, outside
    quotes) and trailing whitespace."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml_subset(text: str):
    """The YAML subset of the settings files: nested block mappings of
    scalars, optionally inside a block sequence (`- key: value`), `#`
    comments. Returns None for an empty document. Raises ValueError on what
    it does not read."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip() and line.strip() != "---":
            if "\t" in line[: len(line) - len(line.lstrip())]:
                raise ValueError(f"tabs in indentation: {raw!r}")
            lines.append(line)
    if not lines:
        return None
    pos = 0

    def block(indent):
        nonlocal pos
        first = lines[pos]
        if first.lstrip().startswith("- ") or first.strip() == "-":
            items = []
            while pos < len(lines):
                line = lines[pos]
                ind = len(line) - len(line.lstrip())
                if ind != indent or not line.lstrip().startswith("-"):
                    break
                rest = line.lstrip()[1:]
                if not rest.strip():
                    pos += 1
                    nested = pos < len(lines) and len(lines[pos]) - len(lines[pos].lstrip()) > indent
                    items.append(block(len(lines[pos]) - len(lines[pos].lstrip())) if nested else None)
                    continue
                if not re.search(r":(\s|$)", rest):  # "- scalar"
                    items.append(_scalar(rest.strip()))
                    pos += 1
                    continue
                # "- key: value": the item is a mapping whose keys sit at the
                # column after the dash
                item_indent = indent + 1 + (len(rest) - len(rest.lstrip()))
                lines[pos] = " " * item_indent + rest.lstrip()
                items.append(block(item_indent))
            return items
        mapping = {}
        while pos < len(lines):
            line = lines[pos]
            ind = len(line) - len(line.lstrip())
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation: {line!r}")
            key, sep, value = line.strip().partition(":")
            if not sep or (value and not value.startswith((" ", "\t"))):
                raise ValueError(f"expected 'key: value': {line!r}")
            key, value = key.strip(), value.strip()
            pos += 1
            if value:
                mapping[_scalar(key)] = _scalar(value)
            elif pos < len(lines) and len(lines[pos]) - len(lines[pos].lstrip()) > indent:
                mapping[_scalar(key)] = block(len(lines[pos]) - len(lines[pos].lstrip()))
            elif pos < len(lines) and lines[pos].lstrip().startswith("- ") \
                    and len(lines[pos]) - len(lines[pos].lstrip()) == indent:
                mapping[_scalar(key)] = block(indent)
            else:
                mapping[_scalar(key)] = None
        return mapping

    out = block(len(lines[0]) - len(lines[0].lstrip()))
    if pos != len(lines):
        raise ValueError(f"could not read the YAML from {lines[pos]!r} on")
    return out
