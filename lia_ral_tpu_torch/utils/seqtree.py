"""Sequence-extractor decoder tree (phonotactic LID pipeline; copied from
lia_ral_tpu/utils/seqtree.py).

Structural equivalent of reference ``LIA_Utils/SequenceExtractor``
(SequenceExtractor.cpp): build a **common-part tree** from n-gram count
files (orders 1..maxOrder), greedily carve out ``nbOutputSymb`` groups of
variable-length input-symbol sequences with as-equal-as-possible total
counts, emit them as a **decoder tree**, and decode symbol streams by
longest-match with backtracking.

The structures are host-side (tree building is inherently pointer-y and
tiny — hundreds of nodes); the surrounding pipeline (GmmTokenizer symbol
emission, n-gram scoring) runs on device.  The decoder-tree text format
matches the reference's save/load exactly
(SequenceDecoder::save/_load, cpp:578-598) so trees interoperate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, TextIO


# ---------------------------------------------------------------------------
# CommonPartTree (cpp:75-250)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CNode:
    symb: int
    count: int
    total_child_count: int = 0
    ch: Optional["_CNode"] = None
    br: Optional["_CNode"] = None


class CommonPartTree:
    """N-gram trie with per-path counts; supports max-count-longest-path
    queries and path suppression (CommonPartTree, cpp:75-250)."""

    def __init__(self) -> None:
        self._seed: Optional[_CNode] = None
        self.total_count = 0
        self.total_child_count = 0

    # -- construction -------------------------------------------------------
    def _find_insert(self, symb: int, count: int,
                     ptr: Optional[_CNode]) -> _CNode:
        if ptr is None:
            return _CNode(symb, count)
        while ptr.symb != symb and ptr.br is not None:
            ptr = ptr.br
        if ptr.symb == symb:
            return ptr
        ptr.br = _CNode(symb, count)
        return ptr.br

    def add_ngrams(self, ngrams: list[tuple[list[int], int]]) -> None:
        """Insert (symbols, count) n-grams of ONE order (addNGram,
        cpp:121-137): a node's count is the count of the n-gram ending
        there; the parent accumulates totalChildCount."""
        for symbols, count in ngrams:
            cur = self._find_insert(symbols[0], count, self._seed)
            if self._seed is None:
                self._seed = cur
            tmp = None
            for s in symbols[1:]:
                tmp = cur
                cur = self._find_insert(s, count, cur.ch)
                if tmp.ch is None:
                    tmp.ch = cur
            if len(symbols) == 1:
                self.total_child_count += count
            else:
                tmp.total_child_count += count

    @classmethod
    def from_ngram_files(cls, base: str, ext: str, max_order: int,
                         max_ngram: int = 1 << 30) -> "CommonPartTree":
        """Reference file layout: ``<base><order><ext>`` text files of
        "s0 s1 ... count" lines (fixture test/ngram1.dta)."""
        tree = cls()
        for order in range(1, max_order + 1):
            ngrams = []
            with open(f"{base}{order}{ext}") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != order + 1:
                        continue
                    ngrams.append(([int(t) for t in parts[:-1]],
                                   int(parts[-1])))
                    if len(ngrams) >= max_ngram:
                        break
            tree.add_ngrams(ngrams)
        tree.total_count = tree.total_child_count
        return tree

    # -- queries ------------------------------------------------------------
    def _find_max(self, ptr: Optional[_CNode], order: int
                  ) -> tuple[int, int, list[int]]:
        """(count, order_out, path) of the longest/heaviest path in the
        chain starting at ptr (faithful port of _findMaxSeq,
        cpp:153-177, including its leaf-returns-incoming-order
        sentinel)."""
        if ptr is None:
            return 0, 0, []
        br_count, order_br, br_path = self._find_max(ptr.br, order)
        ch_count, order_ch, ch_path = self._find_max(ptr.ch, order + 1)
        if order_br < order_ch:
            return ch_count, order_ch, [ptr.symb] + ch_path
        if order_ch == 0:
            if order_br == 0:
                return ptr.count, order, [ptr.symb]
            if order_br > order:
                return br_count, order_br, br_path
            if ptr.count > br_count:
                return ptr.count, order, [ptr.symb]
            return br_count, order_br, br_path
        if order_br > order_ch:
            return br_count, order_br, br_path
        if br_count > ch_count:
            return br_count, order_br, br_path
        return ch_count, order_ch, [ptr.symb] + ch_path

    def find_max_seq(self) -> tuple[int, list[int]]:
        if self._seed is None:
            return 0, []
        count, _, path = self._find_max(self._seed, 0)
        return count, path

    def _find_part(self, path: list[int], order: int,
                   ptr: Optional[_CNode]) -> Optional[_CNode]:
        if ptr is None:
            return None
        if not path:
            return self._seed
        if order >= len(path):
            return None
        if path[order] == ptr.symb:
            if order == len(path) - 1:
                return ptr
            return self._find_part(path, order + 1, ptr.ch)
        return self._find_part(path, order, ptr.br)

    def find_max_end_seq(self, prefix: list[int]) -> tuple[int, list[int]]:
        """Longest/heaviest extension of ``prefix`` (findMaxEndSeq,
        cpp:184-195); a leaf prefix returns its own count unchanged."""
        if not prefix:
            return self.find_max_seq()
        if self._seed is None:
            return 0, list(prefix)
        node = self._find_part(prefix, 0, self._seed)
        if node is None:
            return 0, list(prefix)
        if node.ch is not None:
            count, _, path = self._find_max(node.ch, len(prefix))
            return count, list(prefix) + path
        return node.count, list(prefix)

    # -- suppression --------------------------------------------------------
    def _suppress(self, ptr: Optional[_CNode], path: list[int], order: int
                  ) -> tuple[Optional[_CNode], int]:
        if order >= len(path):
            raise ValueError("sequence longer than the tree")
        head = ptr
        prev = None
        while ptr is not None and path[order] != ptr.symb:
            prev, ptr = ptr, ptr.br
        if ptr is None:
            raise ValueError(f"path {path} not in tree at order {order}")
        if order == len(path) - 1:
            delta = ptr.count
            if prev is None:
                head = ptr.br
            else:
                prev.br = ptr.br
            return head, delta
        ptr.ch, delta = self._suppress(ptr.ch, path, order + 1)
        if ptr.count < delta:
            raise ValueError("count problem in the tree, childcount < delta")
        ptr.total_child_count -= delta
        ptr.count -= delta
        if ptr.count == 0:
            if prev is None:
                head = ptr.br
            else:
                prev.br = ptr.br
        return head, delta

    def suppress_seq(self, path: list[int]) -> None:
        if not path:
            return
        self._seed, delta = self._suppress(self._seed, path, 0)
        self.total_child_count -= delta


# ---------------------------------------------------------------------------
# SequenceDecoder (cpp:432-670)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _DNode:
    symbols: set[int]
    output_symb: int = -1
    ch: Optional["_DNode"] = None
    br: Optional["_DNode"] = None


class SequenceDecoder:
    """Decoder tree: sequences of symbol-sets → output symbol, decoded by
    longest match with backtracking (SequenceDecoder, cpp:432-670)."""

    def __init__(self, nb_input_symb: int) -> None:
        self.nb_input_symb = nb_input_symb
        self.nb_output_seq = 0
        self.nb_output_seq_part = 0
        self._seed: Optional[_DNode] = None

    def _find_insert(self, symbols: set[int],
                     ptr: Optional[_DNode]) -> _DNode:
        if ptr is None:
            return _DNode(set(symbols))
        while ptr.br is not None and ptr.symbols != symbols:
            ptr = ptr.br
        if ptr.symbols == symbols:
            return ptr
        ptr.br = _DNode(set(symbols))
        return ptr.br

    def add_sequence(self, path: list[int] | list[set[int]],
                     output_symb: int) -> None:
        if not path:
            raise ValueError("null length sequence")
        steps = [p if isinstance(p, set) else {p} for p in path]
        cur = self._find_insert(steps[0], self._seed)
        if self._seed is None:
            self._seed = cur
        for step in steps[1:]:
            tmp = self._find_insert(step, cur.ch)
            if cur.ch is None:
                cur.ch = tmp
            cur = tmp
        if cur.output_symb != -1:
            raise ValueError("sequence already mapped")
        cur.output_symb = output_symb
        self.nb_output_seq_part += 1

    # -- reference text format (save cpp:578-598 / _load cpp:545-577) -------
    def _save(self, ptr: Optional[_DNode], f: TextIO) -> None:
        if ptr is None:
            f.write("nil\n")
            return
        while ptr is not None:
            f.write("begin\n")
            self._save(ptr.ch, f)
            syms = " ".join(str(s) for s in sorted(ptr.symbols))
            f.write(f"{ptr.output_symb} {syms} -1\n")
            ptr = ptr.br
        f.write("nil\n")

    def save(self, f: TextIO) -> None:
        f.write(f"{self.nb_input_symb}\n{self.nb_output_seq_part}\n"
                f"{self.nb_output_seq}\n")
        self._save(self._seed, f)

    @classmethod
    def load(cls, f: TextIO) -> "SequenceDecoder":
        toks = f.read().split()
        pos = 0

        def next_tok() -> str:
            nonlocal pos
            t = toks[pos]
            pos += 1
            return t

        dec = cls(int(next_tok()))
        dec.nb_output_seq_part = int(next_tok())
        dec.nb_output_seq = int(next_tok())

        def load_chain() -> Optional[_DNode]:
            tok = next_tok()
            if tok == "nil":
                return None
            head = tail = None
            while tok != "nil":
                if tok != "begin":
                    raise ValueError("nil or begin is missing")
                node = _DNode(set())
                node.ch = load_chain()
                node.output_symb = int(next_tok())
                s = int(next_tok())
                while s != -1:
                    node.symbols.add(s)
                    s = int(next_tok())
                if head is None:
                    head = tail = node
                else:
                    tail.br = node
                    tail = node
                tok = next_tok()
            return head

        dec._seed = load_chain()
        return dec

    # -- decoding (decode/_decode cpp:599-670) -------------------------------
    def decode(self, symbols: list[int], begin: int = 0,
               length: int = 0, overlap: bool = False
               ) -> list[tuple[int, int, int]]:
        """Transcode a symbol stream → [(begin, end, output_symb)] with
        longest-match + backtracking; unknown-prefix symbols are skipped
        with a warning, matching the reference's stderr behaviour."""
        end = len(symbols) if length == 0 else min(begin + length,
                                                   len(symbols))
        out: list[tuple[int, int, int]] = []
        idx = begin

        def match(ptr: Optional[_DNode], i: int,
                  start: int) -> tuple[bool, int]:
            """Try to extend a match from node chain ptr at stream pos i;
            returns (matched, next_index)."""
            while ptr is not None and symbols[i] not in ptr.symbols:
                ptr = ptr.br
            if ptr is None:
                return False, i
            if ptr.ch is None:                      # leaf: sequence ends
                if ptr.output_symb != -1:
                    out.append((start, i, ptr.output_symb))
                return True, i + 1
            if ptr.output_symb == -1:               # must go deeper
                if i + 1 >= end:
                    return False, i
                return match(ptr.ch, i + 1, start)
            if i + 1 >= end:                        # eof: emit current
                out.append((start, i, ptr.output_symb))
                return True, i + 1
            matched, nxt = match(ptr.ch, i + 1, start)
            if not matched:                         # backtrack to here
                out.append((start, i, ptr.output_symb))
                return True, i + 1
            return True, nxt

        while idx < end:
            save_idx = idx
            matched, nxt = match(self._seed, idx, idx)
            if not matched:
                print(f"WARNING, Seq unknown beginning by "
                      f"symb[{symbols[idx]}]idx[{idx}]")
                nxt = idx + 1
            idx = save_idx + 1 if overlap else nxt
        return out


# ---------------------------------------------------------------------------
# sequenceExtractor main algorithm (cpp:732-827)
# ---------------------------------------------------------------------------

def sequence_extractor(tree: CommonPartTree, nb_input_symb: int,
                       nb_output_symb: int,
                       equal_input_info: bool = False,
                       verbose: bool = False
                       ) -> tuple[SequenceDecoder, list[tuple[int, int]]]:
    """Greedy equal-probability sequence carving (sequenceExtractor,
    cpp:732-827): per output symbol, take the max-count longest sequence,
    then agglomerate common-prefix extensions until the per-symbol target
    count (remaining/nb_remaining_symbols) is reached.

    Returns the decoder tree + [(output_symb, total_count)] info."""
    dec = SequenceDecoder(nb_input_symb)
    info: list[tuple[int, int]] = []
    remaining = tree.total_child_count
    for seq_id in range(nb_output_symb):
        target = remaining // (nb_output_symb - seq_id)
        count, path = tree.find_max_seq()
        if equal_input_info:
            count *= len(path)
        if not path:
            break
        tree.suppress_seq(path)
        dec.add_sequence(path, seq_id)
        if verbose:
            print(f"Seq[{seq_id}] len[{len(path)}] count[{count}] {path}")
        length = len(path) - 1
        while count < target and length >= 0:
            end = False
            while not end and length >= 0 and count < target:
                prefix = path[:length]
                delta, new_path = tree.find_max_end_seq(prefix)
                if equal_input_info:
                    delta *= len(new_path)
                end = delta == 0 or len(new_path) == 0
                if not end:
                    count += delta
                    tree.suppress_seq(new_path)
                    dec.add_sequence(new_path, seq_id)
                    path = new_path
                    length = len(path) - 1
                    if verbose:
                        print(f"Seq[{seq_id}] add len[{len(new_path)}] "
                              f"count[{count}] {new_path}")
                else:
                    length -= 1
        remaining -= count
        if count == 0:
            break
        info.append((seq_id, count))
        dec.nb_output_seq = seq_id + 1
    return dec, info
