"""SQL tokenizer: text → positioned tokens (the JAX package's
``sql/tokenizer.py``, copied).

Small by design — the grammar the parser implements (see ``sql/parser.py``)
needs identifiers, numbers, single-quoted strings, ``:name`` parameters,
a dozen operators, and ``--`` comments.  Every token carries its 1-based
``(line, col)`` so parse- and bind-errors render a caret pointing at the
offending character (:class:`SqlError`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List


class SqlError(ValueError):
    """Malformed SQL: tokenizer/parser/binder errors, with the 1-based
    source position and a rendered caret line for diagnostics."""

    def __init__(self, message: str, text: str = "", line: int = 1,
                 col: int = 1):
        self.message = message
        self.text = text
        self.line = line
        self.col = col
        super().__init__(self._render())

    def _render(self) -> str:
        lines = self.text.splitlines()
        if not self.text or not (1 <= self.line <= len(lines)):
            return f"{self.message} (line {self.line}, column {self.col})"
        src = lines[self.line - 1]
        caret = " " * (self.col - 1) + "^"
        return (f"{self.message}\n"
                f"  line {self.line}, column {self.col}:\n"
                f"    {src}\n"
                f"    {caret}")


# token kinds
IDENT = "IDENT"      # bare word (keywords are IDENTs; the parser matches)
NUMBER = "NUMBER"    # value is the parsed int/float
STRING = "STRING"    # value is the unquoted str
PARAM = "PARAM"      # :name — value is the bare name
OP = "OP"            # punctuation/operator, value is the symbol
EOF = "EOF"


@dataclass(frozen=True)
class Token:
    kind: str
    value: Any
    line: int
    col: int

    @property
    def upper(self) -> str:
        return self.value.upper() if isinstance(self.value, str) else ""


_TWO_CHAR = ("<=", ">=", "<>", "!=")
_ONE_CHAR = set("()[],.;*=<>+-/")


def tokenize(text: str) -> List[Token]:
    """Tokenize ``text``; raises :class:`SqlError` (with caret) on a
    character the grammar has no use for or an unterminated string."""
    toks: List[Token] = []
    i, line, bol = 0, 1, 0          # bol = offset of current line start
    n = len(text)
    while i < n:
        ch = text[i]
        col = i - bol + 1
        if ch == "\n":
            i += 1
            line += 1
            bol = i
            continue
        if ch in " \t\r":
            i += 1
            continue
        if text.startswith("--", i):
            while i < n and text[i] != "\n":
                i += 1
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(Token(IDENT, text[i:j], line, col))
            i = j
            continue
        if ch.isdigit():
            j = i
            while j < n and (text[j].isdigit() or text[j] == "."):
                j += 1
            raw = text[i:j]
            try:
                value = float(raw) if "." in raw else int(raw)
            except ValueError:
                raise SqlError(f"bad numeric literal {raw!r}", text,
                               line, col)
            toks.append(Token(NUMBER, value, line, col))
            i = j
            continue
        if ch == "'":
            j = i + 1
            while j < n and text[j] != "'":
                if text[j] == "\n":
                    break
                j += 1
            if j >= n or text[j] != "'":
                raise SqlError("unterminated string literal", text,
                               line, col)
            toks.append(Token(STRING, text[i + 1:j], line, col))
            i = j + 1
            continue
        if ch == ":":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            if j == i + 1:
                raise SqlError("expected parameter name after ':'", text,
                               line, col)
            toks.append(Token(PARAM, text[i + 1:j], line, col))
            i = j
            continue
        if text[i:i + 2] in _TWO_CHAR:
            toks.append(Token(OP, text[i:i + 2], line, col))
            i += 2
            continue
        if ch in _ONE_CHAR:
            toks.append(Token(OP, ch, line, col))
            i += 1
            continue
        raise SqlError(f"unexpected character {ch!r}", text, line, col)
    toks.append(Token(EOF, None, line, (n - bol) + 1))
    return toks
