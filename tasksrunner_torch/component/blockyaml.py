"""A reader and a writer for the block-YAML subset that component files
and run files are written in, so the port needs no PyYAML.

:func:`load_all` reads what the component files use and gives what
``yaml.safe_load_all`` gives for it:

* block mappings and block sequences (of mappings or scalars), a
  sequence's items at the key's indent or deeper, a mapping that starts
  on a ``- `` line;
* plain scalars, resolved as YAML 1.1 does (null, booleans such as
  ``true`` / ``yes`` / ``off``, ints, floats, else a string), and
  single- or double-quoted scalars (always strings);
* plain and quoted scalars that go on over more lines, each indented
  deeper than the key or the dash, folded as YAML folds them (a line
  break is a space, each empty line a newline, a backslash at the end of a
  double-quoted line joins the lines): what ``yaml.safe_dump`` writes for
  a string longer than its line width or one with newlines;
* flow sequences and flow mappings of scalars on one line (``[]``,
  ``[a, b]``, ``{k: v}``);
* comments, and documents separated by ``---``.

Anything else is a :class:`~tasksrunner_torch.errors.ComponentError`
that names the file and the line: tabs in indentation, block scalars
(``|``, ``>``), anchors, aliases and tags, a plain scalar that starts on
the line after its key, nested or multi-line flow collections,
timestamps and sexagesimal numbers, directives, and indentation that
fits no block.

:func:`dump` and :func:`dump_all` write mappings, lists, strings,
numbers, booleans and None in that subset, each scalar on one line (a
string that would read as anything else, or holds a character outside
printable ASCII, double-quoted with escapes), so that ``load_all`` and
``yaml.safe_load_all`` both read back what was written.
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
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line(NamedTuple):
    number: int
    indent: int
    text: str  # without the indent


class _Reader:
    def __init__(self, source: str, raw: list[str] | None = None) -> None:
        self.source = source
        #: every line of the text, for scalars that go on over lines
        self.raw = raw or []

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
        """The quoted scalar at the start of ``text`` (one line) and the
        index past it."""
        value, end = self._scan_quoted(text, 1, number, "a quoted scalar must end on its line")
        return value, end + 1

    def _scan_quoted(self, text: str, p: int, number: int, unterminated: str) -> tuple[str, int]:
        """The quoted scalar whose opening quote is ``text[p - 1]``, folded
        where ``text`` goes on over lines, and the index of its closing
        quote."""
        quote, out = text[p - 1], []
        while True:
            if p >= len(text):
                raise self.error(number, unterminated)
            ch = text[p]
            if ch == quote and quote == "'" and text[p + 1:p + 2] == "'":
                out.append("'")
                p += 2
            elif ch == quote:
                return "".join(out), p
            elif ch == "\\" and quote == '"':
                code = text[p + 1:p + 2]
                if code == "\n":  # an escaped line break joins the lines
                    p += 2
                    while text[p:p + 1] in (" ", "\t"):
                        p += 1
                    continue
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    p += 2
                    continue
                width = _HEX_ESCAPES.get(code)
                digits = text[p + 2:p + 2 + width] if width else ""
                if not width or len(digits) != width or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise self.error(number, f"bad escape in {text.splitlines()[0]!r}")
                out.append(chr(int(digits, 16)))
                p += 2 + width
            elif ch in " \t":
                end = p
                while text[end:end + 1] in (" ", "\t"):
                    end += 1
                if text[end:end + 1] != "\n":  # spaces before a break are dropped
                    out.append(text[p:end])
                p = end
            elif ch == "\n":
                breaks = 0
                while text[p:p + 1] == "\n":
                    breaks += 1
                    p += 1
                    while text[p:p + 1] in (" ", "\t"):
                        p += 1
                out.append(" " if breaks == 1 else "\n" * (breaks - 1))
            else:
                out.append(ch)
                p += 1

    def _rest_is_comment(self, rest: str, number: int) -> None:
        rest = rest.strip(" \t")
        if rest and not rest.startswith("#"):
            raise self.error(number, f"unexpected {rest!r} after a value")

    def _plain(self, text: str) -> str:
        """``text`` up to a comment, stripped."""
        match = re.search(r"(^|\s)#", text)
        return (text[:match.start()] if match else text).strip(" \t")

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
        plain = text[i:end].strip(" \t")
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

    def scalar(self, lines: list[_Line], i: int, rest: str, number: int,
               indent: int) -> tuple[Any, int]:
        """The value ``rest`` written after ``key:`` or ``- `` on line
        ``number`` of a block at ``indent``, with the lines it goes on
        over; returns it and the index of the first line after it."""
        if rest[0] in "\"'":
            value, end = self._quoted_lines(rest, number, indent)
            while i < len(lines) and lines[i].number <= end:
                i += 1
        elif rest[0] in "[{":
            value = self.flow(rest, number)
        else:
            first = self._plain(rest)
            text, ended, last = first, first != rest, number
            while not ended and i < len(lines) and lines[i].indent > indent:
                line = lines[i]
                between = self.raw[last:line.number - 1]
                if any(r.strip(" \t") for r in between):
                    break  # a comment line ends a plain scalar
                if self.split_key(line.text, line.number) is not None:
                    raise self.error(line.number,
                                     "bad indentation (a mapping key inside a plain scalar)")
                more = self._plain(line.text)
                ended = more != line.text
                text += ("\n" * len(between) if between else " ") + more
                last = line.number
                i += 1
            value = self.resolve(text, number)
        self._after_scalar(lines, i, indent)
        return value, i

    def _quoted_lines(self, rest: str, number: int, indent: int) -> tuple[str, int]:
        """The quoted scalar that starts ``rest`` on line ``number``, read
        over as many lines as it takes, and the number of its last line."""
        raw = self.raw[number - 1].rstrip(" \t")
        text = "\n".join([raw] + self.raw[number:])
        value, p = self._scan_quoted(text, len(raw) - len(rest) + 1, number,
                                     "a quoted scalar must end on its line or a deeper one")
        last = number + text.count("\n", 0, p)
        for n in range(number + 1, last + 1):
            line = self.raw[n - 1]
            if line.strip(" \t") and len(line) - len(line.lstrip(" ")) <= indent:
                raise self.error(n, "a quoted scalar's next lines must be indented "
                                    "deeper than its key")
        self._rest_is_comment(text[p + 1:].split("\n", 1)[0], last)
        return value, last

    def split_key(self, text: str, number: int) -> tuple[Any, str] | None:
        """(key, the rest) when ``text`` is ``key: ...``, else None."""
        if text[0] in "\"'":
            try:
                key, end = self.quoted(text, number)
            except ComponentError:
                return None  # a quoted value that goes on over lines
            rest = text[end:].lstrip(" ")
            if rest[:1] == ":" and rest[1:2] in ("", " "):
                return key, rest[1:].strip(" \t")
            return None
        if text[0] in "[{":
            return None
        for i, ch in enumerate(text):
            if ch == "#" and (i == 0 or text[i - 1] == " "):
                return None
            if ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
                return self.resolve(text[:i].rstrip(" \t"), number), text[i + 1:].strip(" \t")
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
                value, i = self.scalar(lines, i + 1, rest, line.number, indent)
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
                out[key], i = self.scalar(lines, i, rest, line.number, indent)
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
    reader = _Reader(source, text.splitlines())
    docs: list[list[_Line]] = [[]]
    for number, raw in enumerate(reader.raw, 1):
        stripped = raw.strip(" \t")
        if not stripped or stripped.startswith("#"):
            continue
        if raw.startswith("---") and (raw == "---" or raw[3] in " \t"):
            if raw[3:].strip(" \t") and not raw[3:].strip(" \t").startswith("#"):
                raise reader.error(number, "content after '---' is not supported")
            docs.append([])
            continue
        if raw.startswith("%") or raw.rstrip(" \t") == "...":
            raise reader.error(number, "directives and '...' are not supported")
        text_part = raw.lstrip(" ")
        if text_part.startswith("\t"):
            raise reader.error(number, "tabs are not allowed in indentation")
        docs[-1].append(_Line(number, len(raw) - len(text_part), text_part.rstrip(" \t")))
    # safe_load_all yields no document for a file that is all comments
    # and, after a leading '---', none for the empty text before it
    if not docs[0] and len(docs) > 1:
        docs = docs[1:]
    if len(docs) == 1 and not docs[0]:
        return []
    return [reader.document(lines) for lines in docs]


# -- the writer --------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./$()][ -~]*$")


def _printable(ch: str) -> bool:
    """Whether ``ch`` may stand as itself in a double-quoted scalar:
    printable, and no line break of YAML 1.1 (NEL, LS, PS) or BOM."""
    code = ord(ch)
    return (0x20 <= code <= 0x7E or (0xA0 <= code <= 0xD7FF and code not in (0x2028, 0x2029))
            or (0xE000 <= code <= 0xFFFD and code != 0xFEFF) or code >= 0x10000)


def _double_quoted(text: str) -> str:
    out = ['"']
    for ch in text:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif _printable(ch):
            out.append(ch)
        elif ord(ch) <= 0xFF:
            out.append(f"\\x{ord(ch):02X}")
        elif ord(ch) <= 0xFFFF:
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    out.append('"')
    return "".join(out)


def _scalar_text(value: Any) -> str:
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
        # YAML 1.1 reads a float only with a dot: 1e-05 -> 1.0e-05
        return text.replace("e", ".0e") if "." not in text and "e" in text else text
    if not isinstance(value, str):
        raise TypeError(f"cannot write a {type(value).__name__} as YAML")
    plain = (_PLAIN_SAFE.match(value) is not None and value == value.strip()
             and ": " not in value and " #" not in value and not value.endswith(":"))
    if plain:
        try:
            plain = _Reader("<dump>").resolve(value, 0) == value
        except ComponentError:
            plain = False  # a date or a sexagesimal number
    return value if plain else _double_quoted(value)


def _emit(value: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict) and value:
        for key, item in value.items():
            head = f"{pad}{_scalar_text(key)}:"
            if isinstance(item, dict) and item:
                out.append(head)
                _emit(item, indent + 2, out)
            elif isinstance(item, list) and item:
                out.append(head)
                _emit(item, indent, out)  # a sequence at its key's indent
            else:
                out.append(f"{head} {_block_text(item)}")
    elif isinstance(value, list) and value:
        for item in value:
            if isinstance(item, (dict, list)) and item:
                nested: list[str] = []
                _emit(item, indent + 2, nested)
                out.append(f"{pad}- {nested[0][indent + 2:]}")
                out.extend(nested[1:])
            else:
                out.append(f"{pad}- {_block_text(item)}")
    else:
        out.append(pad + _block_text(value))


def _block_text(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar_text(value)


def dump(value: Any) -> str:
    """``value`` as one block-YAML document."""
    out: list[str] = []
    _emit(value, 0, out)
    return "\n".join(out) + "\n"


def dump_all(values: Any) -> str:
    """Each of ``values`` as a document, ``---`` between them."""
    return "---\n".join(dump(v) for v in values)
