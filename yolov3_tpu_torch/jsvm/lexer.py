"""Tokenizer for the ES-2020 subset used by the browser port (js/src/*.js).

Part of the port's JS execution harness (see jsvm/__init__.py): the browser
sources run through this embedded interpreter, with no JS engine. The lexer
covers the lexical grammar the port and its tests need: numbers,
single/double-quoted strings, template literals with ``${}`` substitutions
(returned pre-split so the parser can sub-parse the expressions), line and
block comments, and the operator set of js/src.

Framework-neutral copy of ``yolov3_tpu/jsvm/lexer.py`` (the standard library
only; the port imports nothing of the JAX package). tests/test_torch_jsvm.py
pins its code, everything after this docstring, to its original.
"""

from __future__ import annotations


class JsSyntaxError(SyntaxError):
    pass


KEYWORDS = {
    "const", "let", "var", "function", "return", "if", "else", "for", "of",
    "in", "while", "do", "try", "catch", "finally", "throw", "new", "typeof",
    "async", "await", "import", "export", "from", "break", "continue",
    "null", "undefined", "true", "false", "default",
}

# longest-match-first punctuator table
_PUNCT = [
    "...", "===", "!==", ">>>", "**=", "<<=", ">>=", "&&=", "||=", "??=",
    "=>", "===", "==", "!=", "<=", ">=", "&&", "||", "??", "++", "--",
    "+=", "-=", "*=", "/=", "%=", "**", "<<", ">>", "?.",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/",
    "%", "!", "=", "?", ":", ".", "|", "&", "^", "~",
]

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
            "v": "\v", "0": "\0", "\\": "\\", "'": "'", '"': '"',
            "`": "`", "$": "$", "\n": ""}


class Token:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind, value, line):
        self.kind = kind        # num | str | template | ident | keyword | punct | eof
        self.value = value
        self.line = line

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Token({self.kind}, {self.value!r}, line={self.line})"


def _read_escape(src, i, line):
    """Decode the escape starting at the backslash ``src[i]``.

    Returns (text, next_index, line). Shared by string AND template
    lexing so ``\\u``/``\\x`` behave identically in both.
    """
    i += 1
    if i >= len(src):
        raise JsSyntaxError(f"dangling backslash at line {line}")
    e = src[i]
    try:
        if e == "u":
            if src[i + 1] == "{":
                j = src.index("}", i)
                return chr(int(src[i + 2:j], 16)), j + 1, line
            return chr(int(src[i + 1:i + 5], 16)), i + 5, line
        if e == "x":
            return chr(int(src[i + 1:i + 3], 16)), i + 3, line
    except (ValueError, IndexError) as exc:
        raise JsSyntaxError(f"bad \\{e} escape at line {line}") from exc
    if e == "\n":
        line += 1
    return _ESCAPES.get(e, e), i + 1, line


def _read_string(src, i, quote, line):
    out = []
    i += 1
    while i < len(src):
        c = src[i]
        if c == quote:
            return "".join(out), i + 1, line
        if c == "\\":
            text, i, line = _read_escape(src, i, line)
            out.append(text)
            continue
        if c == "\n":
            raise JsSyntaxError(f"unterminated string at line {line}")
        out.append(c)
        i += 1
    raise JsSyntaxError(f"unterminated string at line {line}")


def _read_template(src, i, line):
    """Template literal → list of ('str', chunk) / ('expr', source) parts."""
    parts = []
    chunk = []
    i += 1  # consume backtick
    while i < len(src):
        c = src[i]
        if c == "`":
            if chunk:
                parts.append(("str", "".join(chunk)))
            return parts, i + 1, line
        if c == "\\":
            text, i, line = _read_escape(src, i, line)
            chunk.append(text)
            continue
        if c == "$" and i + 1 < len(src) and src[i + 1] == "{":
            if chunk:
                parts.append(("str", "".join(chunk)))
                chunk = []
            depth = 1
            j = i + 2
            start = j
            while j < len(src) and depth:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                elif src[j] in "'\"":
                    _, j, line = _read_string(src, j, src[j], line)
                    continue
                j += 1
            if depth:
                raise JsSyntaxError(f"unterminated ${{}} at line {line}")
            parts.append(("expr", src[start:j - 1]))
            i = j
            continue
        if c == "\n":
            line += 1
        chunk.append(c)
        i += 1
    raise JsSyntaxError(f"unterminated template literal at line {line}")


def tokenize(src: str):
    tokens = []
    i, line = 0, 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            if j < 0:
                raise JsSyntaxError(f"unterminated comment at line {line}")
            line += src.count("\n", i, j)
            i = j + 2
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
                tokens.append(Token("num", float(int(src[i:j], 16)), line))
                i = j
                continue
            seen_dot = False
            while j < n and (src[j].isdigit() or (src[j] == "." and not seen_dot)):
                if src[j] == ".":
                    seen_dot = True
                j += 1
            if j < n and src[j] in "eE":
                j += 1
                if j < n and src[j] in "+-":
                    j += 1
                while j < n and src[j].isdigit():
                    j += 1
            tokens.append(Token("num", float(src[i:j]), line))
            i = j
            continue
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            word = src[i:j]
            tokens.append(Token("keyword" if word in KEYWORDS else "ident",
                                word, line))
            i = j
            continue
        if c in "'\"":
            s, i, line = _read_string(src, i, c, line)
            tokens.append(Token("str", s, line))
            continue
        if c == "`":
            parts, i, line = _read_template(src, i, line)
            tokens.append(Token("template", parts, line))
            continue
        for p in _PUNCT:
            if src.startswith(p, i):
                tokens.append(Token("punct", p, line))
                i += len(p)
                break
        else:
            raise JsSyntaxError(f"unexpected character {c!r} at line {line}")
    tokens.append(Token("eof", None, line))
    return tokens
