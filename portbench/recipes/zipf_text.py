"""``zipf_text``: natural-language text in the manner of the Silesia
corpus's English texts (dickens, webster, reymont).

A vocabulary of lowercase words, picked by Zipf rank; sentences of a few
words, capitalised, each closed by a punctuation mark; a line break at
the first space past a column.  The mix's ``layout_seed`` fixes the
layout: each rank's word length, the ranks in their order, the sentence
ends and their marks.  The run's seed makes the bytes: every word's
letters.  So every seed's text has the same words in the same places,
spelt differently, and puts the same work on the codec.

Parameters (the traffic file): ``vocab``, ``word_letters`` [lo, hi],
``zipf_exponent``, ``sentence_words`` [lo, hi], ``enders``,
``line_width``, ``layout_seed``.
"""

from __future__ import annotations

import numpy as np


def make(p: dict, nbytes: int, seed: int) -> bytes:
    lo, hi = p["word_letters"]
    nv = p["vocab"]
    layout = np.random.default_rng((p["layout_seed"], 0x7E47))
    wlen = layout.integers(lo, hi + 1, nv)
    letters = np.random.default_rng((seed, 0x7E47)).integers(
        ord("a"), ord("z") + 1, (nv, hi), dtype=np.uint8)
    weight = 1.0 / np.arange(1, nv + 1, dtype=np.float64) ** p["zipf_exponent"]
    cdf = np.cumsum(weight / weight.sum())
    enders = p["enders"].encode()
    slo, shi = p["sentence_words"]
    # every word as a sentence's first word (capitalised), inside one,
    # and last (with each mark), each followed by a space
    plain = [letters[i, : wlen[i]].tobytes() for i in range(nv)]
    table = [w + b" " for w in plain]
    table += [w[:1].upper() + w[1:] + b" " for w in plain]
    for m in enders:
        table += [w + bytes([m]) + b" " for w in plain]
    # a quarter more words than nbytes needs on average (a word, its space
    # and a mark in every sentence)
    mean = (lo + hi) / 2 + 1 + 1 / shi
    nwords = int(nbytes / mean * 1.25) + 4 * shi
    words = np.minimum(np.searchsorted(cdf, layout.random(nwords)), nv - 1)
    ends = np.cumsum(layout.integers(slo, shi + 1, nwords // slo + 1))
    ends = ends[ends <= nwords]
    kind = np.zeros(nwords, np.int64)
    kind[0] = 1
    kind[ends[:-1]] = 1
    kind[ends - 1] = 2 + layout.integers(0, len(enders), len(ends))
    ids = (kind * nv + words).tolist()
    text = bytearray()
    at = 0
    while len(text) < nbytes + 2 * p["line_width"]:
        if at >= len(ids):
            raise ValueError(f"zipf_text: seed {seed} ran out of words")
        text += b"".join([table[i] for i in ids[at : at + 65536]])
        at += 65536
    col = p["line_width"]
    at = text.find(b" ", col)
    while at >= 0:
        text[at] = 0x0A
        at = text.find(b" ", at + 1 + col)
    return bytes(text[:nbytes])
