"""A reader for the block-YAML subset that component files are written in,
so the port needs no PyYAML.

:func:`load_all` reads what the component files use and gives what
``yaml.safe_load_all`` gives for it:

* block mappings and block sequences (of mappings or scalars), a
  sequence's items at the key's indent or deeper, a mapping that starts
  on a ``- `` line;
* plain scalars, resolved as YAML 1.1 does (null, booleans such as
  ``true`` / ``yes`` / ``off``, ints, floats, else a string), and
  single- or double-quoted scalars (always strings);
* flow sequences and flow mappings of scalars on one line (``[]``,
  ``[a, b]``, ``{k: v}``);
* comments, and documents separated by ``---``.

Anything else is a :class:`~tasksrunner_torch.errors.ComponentError`
that names the file and the line: tabs in indentation, block scalars
(``|``, ``>``), anchors, aliases and tags, multi-line scalars, nested
flow collections, timestamps and sexagesimal numbers, directives, and
indentation that fits no block.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

from tasksrunner_torch.errors import ComponentError

# YAML 1.1's implicit types, as PyYAML's resolver spells them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = frozenset({"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"})
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# read by YAML 1.1 as sexagesimal numbers or timestamps: not in the subset
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line(NamedTuple):
    number: int
    indent: int
    text: str  # without the indent


class _Reader:
    def __init__(self, source: str) -> None:
        self.source = source

    def error(self, number: int, message: str) -> ComponentError:
        return ComponentError(f"{self.source}:{number}: {message}")

    # -- scalars ---------------------------------------------------------

    def resolve(self, text: str, number: int) -> Any:
        """A plain scalar's value."""
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text in _TRUE
        if _INT.match(text):
            digits = text.replace("_", "")
            sign = -1 if digits[0] == "-" else 1
            digits = digits.lstrip("+-")
            if digits == "0":
                return 0
            if digits.startswith("0b"):
                return sign * int(digits[2:], 2)
            if digits.startswith("0x"):
                return sign * int(digits[2:], 16)
            if digits.startswith("0"):
                return sign * int(digits, 8)
            return sign * int(digits)
        if _FLOAT.match(text):
            digits = text.replace("_", "").lower()
            if digits.endswith(".inf"):
                return float("-inf") if digits[0] == "-" else float("inf")
            if digits == ".nan":
                return float("nan")
            return float(digits)
        if _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text):
            raise self.error(number, f"{text!r} would be read as a number or a date; quote it")
        if text[0] in "&*!|>%@`":
            raise self.error(number, f"{text[0]!r} (anchors, aliases, tags, block "
                                     "scalars, reserved indicators) is not supported")
        return text

    def quoted(self, text: str, number: int) -> tuple[str, int]:
        """The quoted scalar at the start of ``text`` and the index past it."""
        quote, out, i = text[0], [], 1
        while i < len(text):
            ch = text[i]
            if quote == "'":
                if ch == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(ch)
            elif ch == '"':
                return "".join(out), i + 1
            elif ch == "\\":
                code = text[i + 1:i + 2]
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    i += 2
                    continue
                width = _HEX_ESCAPES.get(code)
                digits = text[i + 2:i + 2 + width] if width else ""
                if not width or len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise self.error(number, f"bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + width
                continue
            else:
                out.append(ch)
            i += 1
        raise self.error(number, "a quoted scalar must end on its line")

    def _rest_is_comment(self, rest: str, number: int) -> None:
        rest = rest.strip()
        if rest and not rest.startswith("#"):
            raise self.error(number, f"unexpected {rest!r} after a value")

    def _plain(self, text: str) -> str:
        """``text`` up to a comment, stripped."""
        match = re.search(r"(^|\s)#", text)
        return (text[:match.start()] if match else text).strip()

    @staticmethod
    def _skip(text: str, i: int) -> int:
        while i < len(text) and text[i] == " ":
            i += 1
        return i

    def _flow_scalar(self, text: str, i: int, stops: str, number: int) -> tuple[Any, int]:
        i = self._skip(text, i)
        if text[i:i + 1] in ("[", "{"):
            raise self.error(number, "nested flow collections are not supported")
        if text[i:i + 1] in ("'", '"'):
            value, length = self.quoted(text[i:], number)
            return value, i + length
        end = i
        while end < len(text) and text[end] not in stops:
            end += 1
        plain = text[i:end].strip()
        if not plain:
            raise self.error(number, f"empty entry in {text!r}")
        return self.resolve(plain, number), end

    def flow(self, text: str, number: int) -> Any:
        """A one-line flow sequence or mapping of scalars."""
        close = "]" if text[0] == "[" else "}"
        items: list = []
        entries: dict = {}
        i = 1
        while True:
            i = self._skip(text, i)
            if i >= len(text):
                raise self.error(number, "a flow collection must end on its line")
            if text[i] == close:
                break
            if close == "]":
                value, i = self._flow_scalar(text, i, ",]", number)
                items.append(value)
            else:
                key, i = self._flow_scalar(text, i, ":,}", number)
                i = self._skip(text, i)
                if text[i:i + 1] != ":":
                    raise self.error(number, f"flow mapping entries need 'key: value': {text!r}")
                entries[key], i = self._flow_scalar(text, i + 1, ",}", number)
            i = self._skip(text, i)
            if text[i:i + 1] == ",":
                i += 1
            elif text[i:i + 1] != close:
                raise self.error(number, f"expected ',' or {close!r} in {text!r}")
        self._rest_is_comment(text[i + 1:], number)
        return items if close == "]" else entries

    def value(self, text: str, number: int) -> Any:
        """The value written after ``key:`` or ``- `` on one line."""
        if text[0] in "\"'":
            value, end = self.quoted(text, number)
            self._rest_is_comment(text[end:], number)
            return value
        if text[0] in "[{":
            return self.flow(text, number)
        return self.resolve(self._plain(text), number)

    def split_key(self, text: str, number: int) -> tuple[Any, str] | None:
        """(key, the rest) when ``text`` is ``key: ...``, else None."""
        if text[0] in "\"'":
            key, end = self.quoted(text, number)
            rest = text[end:].lstrip(" ")
            if rest[:1] == ":" and rest[1:2] in ("", " "):
                return key, rest[1:].strip()
            return None
        if text[0] in "[{":
            return None
        for i, ch in enumerate(text):
            if ch == "#" and (i == 0 or text[i - 1] == " "):
                return None
            if ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
                return self.resolve(text[:i].rstrip(), number), text[i + 1:].strip()
        return None

    # -- blocks ----------------------------------------------------------

    @staticmethod
    def _is_item(line: _Line) -> bool:
        return line.text == "-" or line.text.startswith("- ")

    @staticmethod
    def _empty(rest: str) -> bool:
        return not rest or rest.startswith("#")

    def node(self, lines: list[_Line], i: int) -> tuple[Any, int]:
        if self._is_item(lines[i]):
            return self.sequence(lines, i, lines[i].indent)
        return self.mapping(lines, i, lines[i].indent)

    def _nested(self, lines: list[_Line], i: int, indent: int) -> tuple[Any, int]:
        """The block under a ``key:`` or ``-`` whose value is on the next
        lines (None when there is none)."""
        if i < len(lines) and lines[i].indent > indent:
            return self.node(lines, i)
        return None, i

    def _after_scalar(self, lines: list[_Line], i: int, indent: int) -> None:
        if i < len(lines) and lines[i].indent > indent:
            raise self.error(lines[i].number, "a scalar must fit on one line "
                                              "(or bad indentation)")

    def sequence(self, lines: list[_Line], i: int, indent: int) -> tuple[list, int]:
        items = []
        while i < len(lines) and lines[i].indent == indent and self._is_item(lines[i]):
            line = lines[i]
            body = line.text[1:]
            rest = body.lstrip(" ")
            if self._empty(rest):
                value, i = self._nested(lines, i + 1, indent)
            elif self._is_item(_Line(0, 0, rest)) or self.split_key(rest, line.number):
                # a sequence or mapping that starts on the dash's line
                lines[i] = _Line(line.number, indent + 1 + len(body) - len(rest), rest)
                value, i = self.node(lines, i)
            else:
                value = self.value(rest, line.number)
                i += 1
                self._after_scalar(lines, i, indent)
            items.append(value)
        if i < len(lines) and lines[i].indent > indent:
            raise self.error(lines[i].number, "bad indentation")
        return items, i

    def mapping(self, lines: list[_Line], i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(lines) and lines[i].indent == indent:
            line = lines[i]
            if self._is_item(line):
                raise self.error(line.number, "a sequence item where a mapping key belongs")
            split = self.split_key(line.text, line.number)
            if split is None:
                raise self.error(line.number, f"expected 'key: value', got {line.text!r}")
            key, rest = split
            if key == "<<":
                raise self.error(line.number, "merge keys are not supported")
            i += 1
            if not self._empty(rest):
                out[key] = self.value(rest, line.number)
                self._after_scalar(lines, i, indent)
            elif i < len(lines) and lines[i].indent == indent and self._is_item(lines[i]):
                out[key], i = self.sequence(lines, i, indent)
            else:
                out[key], i = self._nested(lines, i, indent)
        if i < len(lines) and lines[i].indent > indent:
            raise self.error(lines[i].number, "bad indentation")
        return out, i

    def document(self, lines: list[_Line]) -> Any:
        if not lines:
            return None
        value, i = self.node(lines, 0)
        if i < len(lines):
            raise self.error(lines[i].number, "bad indentation")
        return value


def load_all(text: str, source: str = "<string>") -> list[Any]:
    """Every document in ``text`` (an empty one as None), as
    ``yaml.safe_load_all`` reads the subset."""
    reader = _Reader(source)
    docs: list[list[_Line]] = [[]]
    for number, raw in enumerate(text.splitlines(), 1):
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if raw.startswith("---") and (raw == "---" or raw[3] in " \t"):
            if raw[3:].strip() and not raw[3:].strip().startswith("#"):
                raise reader.error(number, "content after '---' is not supported")
            docs.append([])
            continue
        if raw.startswith("%") or raw.rstrip() == "...":
            raise reader.error(number, "directives and '...' are not supported")
        text_part = raw.lstrip(" ")
        if text_part.startswith("\t"):
            raise reader.error(number, "tabs are not allowed in indentation")
        docs[-1].append(_Line(number, len(raw) - len(text_part), text_part.rstrip()))
    # safe_load_all yields no document for a file that is all comments
    # and, after a leading '---', none for the empty text before it
    if not docs[0] and len(docs) > 1:
        docs = docs[1:]
    if len(docs) == 1 and not docs[0]:
        return []
    return [reader.document(lines) for lines in docs]
