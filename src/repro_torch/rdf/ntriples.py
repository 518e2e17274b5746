"""Minimal N-Triples reader/writer.

The evaluation datasets are generated in-process (``generator.py``), but a
production deployment ingests N-Triples from a data lake, so the loader is a
first-class substrate component.  Handles IRIs (``<...>``), plain/typed
literals and blank nodes; skips comments and blank lines.
"""

from __future__ import annotations

from typing import List, Tuple


def _parse_term(s: str, pos: int) -> Tuple[str, int]:
    """Parse one term starting at pos; return (term, next_pos)."""
    while pos < len(s) and s[pos].isspace():
        pos += 1
    if pos >= len(s):
        raise ValueError(f"unexpected end of line in {s!r}")
    c = s[pos]
    if c == "<":  # IRI
        end = s.index(">", pos)
        return s[pos + 1 : end], end + 1
    if c == '"':  # literal, possibly with ^^type or @lang
        end = pos + 1
        while end < len(s):
            if s[end] == "\\":
                end += 2
                continue
            if s[end] == '"':
                break
            end += 1
        lit_end = end + 1
        # consume datatype / langtag
        if lit_end < len(s) and s[lit_end] == "@":
            while lit_end < len(s) and not s[lit_end].isspace():
                lit_end += 1
        elif s[lit_end : lit_end + 2] == "^^":
            lit_end += 2
            if lit_end < len(s) and s[lit_end] == "<":
                lit_end = s.index(">", lit_end) + 1
        return s[pos:lit_end], lit_end
    if c == "_":  # blank node _:b0
        end = pos
        while end < len(s) and not s[end].isspace():
            end += 1
        return s[pos:end], end
    raise ValueError(f"cannot parse term at {s[pos:pos+40]!r}")


def parse_ntriples(text: str) -> List[Tuple[str, str, str]]:
    triples = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        s, pos = _parse_term(line, 0)
        p, pos = _parse_term(line, pos)
        o, pos = _parse_term(line, pos)
        triples.append((s, p, o))
    return triples


def write_ntriples(triples, path: str) -> None:
    def fmt(t: str) -> str:
        if t.startswith('"') or t.startswith("_:"):
            return t
        return f"<{t}>"

    with open(path, "w") as f:
        for s, p, o in triples:
            f.write(f"{fmt(s)} {fmt(p)} {fmt(o)} .\n")
