"""A reader for the YAML subset the offline tools' documents use.

The reference's cryptogen and configtxgen read their configuration
through PyYAML (fabric_mod_tpu/cli/cryptogen.py:28, configtxgen.py:20);
the port imports no `yaml`, so it reads the documents itself.  The
subset is what those documents hold (the reference's docstrings,
cli/cryptogen.py:8-22 and configtxgen.py:7-15, and tests/test_cli.py):

* block mappings (`Key: value`, `Key:` over an indented block);
* block sequences, of mappings (`- Name: Org1` with its keys indented
  under the first) or of scalars;
* flow sequences of scalars (`[Org1, Org2]`);
* scalars that are decimal integers or strings, plain or quoted;
* `#` comments, blank lines, one leading `---`.

`load` gives what `yaml.safe_load` gives on such a document.  Anything
else raises YamlSubsetError naming the line: anchors and aliases, tags,
block scalars, flow mappings, a second document, directives, tabs, and
every plain scalar that YAML would resolve to something other than a
decimal integer or a string (booleans such as `yes`, nulls, floats,
octal or hexadecimal integers, timestamps).  The reader never guesses.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple


class YamlSubsetError(ValueError):
    """The document is outside the subset the reader takes."""


_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
# YAML 1.1's implicit types other than str (PyYAML's resolver): a plain
# scalar matching one of these would not be read as the string it looks
# like, and the subset takes none of them
_OTHER_TYPES = (
    ("a boolean", re.compile(
        r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
        r"FALSE|on|On|ON|off|Off|OFF)$")),
    ("a null", re.compile(r"^(?:~|null|Null|NULL)$")),
    ("a float", re.compile(
        r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?"
        r"|\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?"
        r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
        r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")),
    ("a non-decimal integer", re.compile(
        r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
        r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")),
    ("a timestamp", re.compile(
        r"^(?:[0-9]{4}-[0-9]{2}-[0-9]{2}"
        r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:"
        r"[0-9]{2}:[0-9]{2}(?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?)$")),
    ("a merge key", re.compile(r"^<<$")),
    ("a value key", re.compile(r"^=$")),
)
# what a plain scalar may not start with in the subset: indicators of
# anchors, aliases, tags, block scalars, flow mappings, directives and
# reserved characters
_BAD_START = {"&": "an anchor", "*": "an alias", "!": "a tag",
              "|": "a block scalar", ">": "a block scalar",
              "{": "a flow mapping", "}": "a flow mapping",
              "%": "a directive", "@": "a reserved indicator",
              "`": "a reserved indicator", "?": "a complex key",
              ",": "a stray comma", "]": "a stray bracket"}


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no = no
        self.indent = indent
        self.text = text


def _fail(no: int, why: str) -> YamlSubsetError:
    return YamlSubsetError(f"line {no}: {why}")


def _strip_comment(raw: str, no: int) -> str:
    """The line without its comment: `#` at the start or after
    whitespace, outside quotes."""
    quote: Optional[str] = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote:
            if c == quote:
                if quote == "'" and raw[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif c == "\\" and quote == '"':
                i += 1
        elif c in "'\"" and (i == 0 or raw[i - 1] in " \t[,-:"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        i += 1
    if quote:
        raise _fail(no, "an unterminated quoted scalar")
    return raw.rstrip()


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    seen_content = False
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            raise _fail(no, "a tab in the indentation")
        body = _strip_comment(raw, no)
        if not body.strip():
            continue
        if body.startswith("%"):
            raise _fail(no, "a directive")
        if body.rstrip() in ("---", "...") or body.startswith(("--- ",
                                                               "... ")):
            if body.startswith("...") or seen_content or body != "---":
                raise _fail(no, "a second document (or a document "
                                "marker with content)")
            seen_content = True
            continue
        seen_content = True
        stripped = body.lstrip(" ")
        out.append(_Line(no, len(body) - len(stripped), stripped))
    return out


def _quoted(s: str, no: int) -> str:
    q = s[0]
    if len(s) < 2 or s[-1] != q:
        raise _fail(no, f"text after a quoted scalar: {s!r}")
    body = s[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise _fail(no, f"a stray quote in {s!r}")
        return body.replace("''", "'")
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\":
            nxt = body[i + 1:i + 2]
            if nxt not in ('"', "\\"):
                raise _fail(no, f"an escape outside the subset: \\{nxt}")
            out.append(nxt)
            i += 2
            continue
        if c == '"':
            raise _fail(no, f"a stray quote in {s!r}")
        out.append(c)
        i += 1
    return "".join(out)


def _scalar(s: str, no: int, flow: bool = False) -> Any:
    s = s.strip()
    if not s:
        raise _fail(no, "an empty scalar")
    if s[0] in "'\"":
        return _quoted(s, no)
    if s[0] in _BAD_START:
        raise _fail(no, f"{_BAD_START[s[0]]} ({s!r}) is outside the subset")
    if s[0] == "[":
        raise _fail(no, "a nested flow sequence")
    if s.startswith("- ") or s == "-":
        raise _fail(no, f"a sequence entry where a scalar belongs: {s!r}")
    if ": " in s or s.endswith(":"):
        raise _fail(no, f"a mapping inside a scalar: {s!r}")
    if " #" in s:
        raise _fail(no, f"a comment inside a scalar: {s!r}")
    if flow and any(c in s for c in "[]{}"):
        raise _fail(no, f"flow indicators inside {s!r}")
    if _DECIMAL.match(s):
        return int(s)
    for what, pat in _OTHER_TYPES:
        if pat.match(s):
            raise _fail(no, f"{s!r} reads as {what} in YAML; the subset "
                            f"takes decimal integers and strings only "
                            f"(quote it to mean the string)")
    return s


def _value(s: str, no: int) -> Any:
    """A value on a key's or a sequence entry's own line."""
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise _fail(no, f"an unterminated flow sequence: {s!r}")
        inner = s[1:-1].strip()
        if not inner:
            return []
        items = _split_flow(inner, no)
        if items and items[-1] == "":
            items.pop()                  # YAML allows one trailing comma
        if any(not it for it in items):
            raise _fail(no, f"an empty entry in {s!r}")
        return [_scalar(it, no, flow=True) for it in items]
    return _scalar(s, no)


def _split_flow(inner: str, no: int) -> List[str]:
    items, cur, quote = [], [], None
    for c in inner:
        if quote:
            cur.append(c)
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
            cur.append(c)
        elif c == ",":
            items.append("".join(cur).strip())
            cur = []
        elif c in "[]{}":
            raise _fail(no, "a nested flow collection")
        else:
            cur.append(c)
    items.append("".join(cur).strip())
    return items


def _split_key(text: str, no: int) -> Tuple[Any, str]:
    """(key, the rest of the line) of a mapping entry."""
    if text[0] in "'\"":
        end = text.find(text[0], 1)
        while end != -1 and text[0] == "'" and text[end + 1:end + 2] == "'":
            end = text.find("'", end + 2)
        if end == -1:
            raise _fail(no, "an unterminated quoted key")
        key = _quoted(text[:end + 1], no)
        rest = text[end + 1:]
        if not (rest == ":" or rest.startswith(": ")):
            raise _fail(no, f"a quoted key without ':' in {text!r}")
        return key, rest[1:]
    m = re.search(r":(?: |$)", text)
    if m is None:
        raise _fail(no, f"not a mapping entry: {text!r}")
    return _scalar(text[:m.start()], no), text[m.end():]


def _is_entry(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        line = self.peek()
        if _is_entry(line.text):
            return self.sequence(indent)
        return self.mapping(indent)

    def nested(self, parent_indent: int, allow_same_seq: bool) -> Any:
        """The block under a key or an entry with no inline value."""
        nxt = self.peek()
        if nxt is not None and (nxt.indent > parent_indent or (
                allow_same_seq and nxt.indent == parent_indent
                and _is_entry(nxt.text))):
            return self.block(nxt.indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line.no, "unexpected indentation")
            if _is_entry(line.text):
                raise _fail(line.no, "a sequence entry inside a mapping")
            key, rest = _split_key(line.text, line.no)
            if key in out:
                raise _fail(line.no, f"a duplicate key {key!r}")
            self.i += 1
            if rest.strip():
                out[key] = _value(rest, line.no)
            else:
                out[key] = self.nested(indent, allow_same_seq=True)

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _fail(line.no, "unexpected indentation")
            if not _is_entry(line.text):
                return out               # the parent mapping goes on
            body = line.text[1:]
            content = body.lstrip(" ")
            if not content:
                self.i += 1
                out.append(self.nested(indent, allow_same_seq=False))
                continue
            col = indent + 1 + (len(body) - len(content))
            if _is_entry(content):
                raise _fail(line.no, "a compact nested sequence")
            if (content[0] not in "'\"[" and re.search(r":(?: |$)", content)) \
                    or (content[0] in "'\"" and re.match(
                        r"^(['\"]).*?\1:(?: |$)", content)):
                # a mapping whose first key sits on the entry's line
                self.lines[self.i] = _Line(line.no, col, content)
                out.append(self.mapping(col))
            else:
                self.i += 1
                out.append(_value(content, line.no))


def load(text: str) -> Any:
    """The document `text` as `yaml.safe_load` reads it (None for an
    empty one); YamlSubsetError outside the subset."""
    lines = _lines(text)
    if not lines:
        return None
    p = _Parser(lines)
    first = lines[0]
    if first.indent:
        raise _fail(first.no, "an indented top level")
    if len(lines) == 1 and not _is_entry(first.text) and \
            re.search(r":(?: |$)", first.text) is None:
        return _value(first.text, first.no)
    out = p.block(0)
    line = p.peek()
    if line is not None:
        raise _fail(line.no, "unexpected content after the top block")
    return out


def load_file(path: str) -> Any:
    with open(path) as f:
        return load(f.read())
