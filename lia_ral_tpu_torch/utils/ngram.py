"""N-gram counting and sequence decoding over symbol streams (copied from
lia_ral_tpu/utils/ngram.py).

Equivalents of reference ``LIA_Utils/BNGram`` (n-gram counting toolset),
``LabelNGram`` (n-grams over label streams with codebooks) and
``SequenceExtractor``/``SequenceDecoder`` (decoder tree from n-grams +
symbol-sequence decoding) — the phonotactic language-ID pipeline
(SURVEY.md §2.4).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np


def ngram_counts(symbols, order: int) -> Counter:
    """Counts of all n-grams of the given order in a symbol sequence."""
    symbols = list(symbols)
    return Counter(tuple(symbols[i:i + order])
                   for i in range(len(symbols) - order + 1))


@dataclasses.dataclass
class NGramModel:
    """Backoff-free n-gram model with add-delta smoothing."""

    order: int
    counts: Counter
    context_counts: Counter
    vocab: set
    delta: float = 0.5

    @classmethod
    def train(cls, sequences, order: int, delta: float = 0.5) -> "NGramModel":
        counts: Counter = Counter()
        ctx: Counter = Counter()
        vocab = set()
        for seq in sequences:
            seq = list(seq)
            vocab.update(seq)
            for i in range(len(seq) - order + 1):
                g = tuple(seq[i:i + order])
                counts[g] += 1
                ctx[g[:-1]] += 1
        return cls(order, counts, ctx, vocab, delta)

    def log_prob(self, gram: tuple) -> float:
        v = max(len(self.vocab), 1)
        c = self.counts.get(gram, 0)
        n = self.context_counts.get(gram[:-1], 0)
        return float(np.log((c + self.delta) / (n + self.delta * v)))

    def sequence_log_likelihood(self, symbols) -> float:
        symbols = list(symbols)
        if len(symbols) < self.order:
            return 0.0
        return sum(self.log_prob(tuple(symbols[i:i + self.order]))
                   for i in range(len(symbols) - self.order + 1))


OOV = -1


def read_ngram_codebook(path: str, order: int,
                        n_selected: int | None = None):
    """Load a bag-of-ngram codebook file: one n-gram per line,
    ``s1 .. s_order [count]``, keeping the first ``n_selected`` entries
    (reference NGram::load, LabelNGram.cpp:160-186)."""
    grams: list[tuple[int, ...]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            grams.append(tuple(int(p) for p in parts[:order]))
            if n_selected is not None and len(grams) >= n_selected:
                break
    return grams


def label_ngram(symbols, codebook, order: int,
                segments: list[tuple[int, int]] | None = None):
    """Transform a per-frame token stream into labelled frame segments
    using a bag-of-ngram codebook (reference computeLabelNGram,
    LabelNGram.cpp:203-268).

    Consecutive identical symbols form one token run; a sliding window of
    ``order`` runs is matched against the codebook.  A hit emits a segment
    spanning the window's frames labelled with the (1-based, as in the
    reference's post-increment ``isNGram`` tag) codebook index; unmatched
    stretches are labelled ``"oov"``.  Returns a list of
    ``(begin_frame, end_frame_exclusive, label)``.
    """
    symbols = [OOV if s == "oov" else int(s) for s in symbols]
    nb_sym = len(symbols)
    if segments is None:
        segments = [(0, nb_sym)]
    out: list[tuple[int, int, str]] = []

    def emit(b, e_excl, label):
        if e_excl > b:
            out.append((b, e_excl, label))

    for seg_begin, seg_end in segments:
        end_s = min(seg_end, nb_sym)
        idx = min(seg_begin, end_s)
        begin_oov = idx
        oov = True
        begins: list[int] = []
        syms: list[int] = []
        ends: list[int] = []

        def recognize(idx):
            sym = symbols[idx]
            while idx < end_s and symbols[idx] == sym:
                idx += 1
            return sym, idx

        while idx < end_s and len(syms) < order - 1:
            begins.append(idx)
            sym, idx = recognize(idx)
            syms.append(sym)
            ends.append(idx - 1)
        while idx < end_s:
            begins.append(idx)
            sym, idx = recognize(idx)
            syms.append(sym)
            ends.append(idx - 1)
            window = tuple(syms)
            tag = None
            for i, gram in enumerate(codebook):
                if gram == window:
                    tag = i + 1
                    break
            if tag is not None:
                if oov and begin_oov < begins[0]:
                    emit(begin_oov, begins[0], "oov")
                emit(begins[0], ends[-1] + 1, str(tag))
                begin_oov = idx
                oov = False
            else:
                oov = True
            begins.pop(0)
            syms.pop(0)
            ends.pop(0)
        if oov:
            emit(begin_oov, idx, "oov")
    return out


def sequence_decode(symbols, models: dict[str, NGramModel],
                    normalize: bool = True) -> tuple[str, dict[str, float]]:
    """Classify a symbol sequence by max n-gram likelihood (reference
    SequenceDecoder: walk the decoder tree built from per-class n-grams).
    Returns (best class, per-class log-likelihoods)."""
    n = max(len(list(symbols)), 1)
    scores = {}
    for name, m in models.items():
        ll = m.sequence_log_likelihood(symbols)
        scores[name] = ll / n if normalize else ll
    best = max(scores, key=scores.get)
    return best, scores
