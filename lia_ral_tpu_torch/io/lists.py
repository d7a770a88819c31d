"""List-file parsing: XList/XLine and NDX trial lists.

A copy of ``lia_ral_tpu/io/lists.py`` (numpy only): the port may not
import the JAX package, whose ``__init__`` imports jax.

Capability parity with ALIZE XList/XLine (SURVEY.md §1.1, ~1100 uses).
An XList file is lines of whitespace-separated tokens; NDX trial lists put
the test segment first followed by the models scored against it
(reference ``LIA_SpkDet/ComputeTest/test/ndx``: "test3 test1 test2"), and
target-id lists put the client first followed by its training files
(``TrainTarget.cpp:122``).
"""

from __future__ import annotations


def read_xlist(path: str) -> list[list[str]]:
    """Read a list file → list of token lines (empty lines skipped)."""
    out: list[list[str]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = line.split()
            if toks:
                out.append(toks)
    return out


def write_xlist(path: str, lines: list[list[str]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for toks in lines:
            f.write(" ".join(toks) + "\n")


def read_ndx(path: str) -> list[tuple[str, list[str]]]:
    """NDX line → (first_token, remaining_tokens).

    For ComputeTest NDX: (test_segment, [model...]).
    For TrainTarget id lists: (client_id, [feature_file...])."""
    return [(toks[0], toks[1:]) for toks in read_xlist(path)]


def read_simple_list(path: str) -> list[str]:
    """One name per line (possibly several per line) → flat name list."""
    return [t for toks in read_xlist(path) for t in toks]
