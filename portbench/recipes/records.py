"""``records``: database records in the manner of Silesia's osdb and nci.

Words from a turning local vocabulary, each followed by a 2-byte
separator, after the recipe of the port's MB corpus
(``x3tpu_torch/utils/corpus.py``, its seeded section), frozen here so
that the benchmark's data does not change with the program.  The mix's
``layout_seed`` fixes the layout: each word's length, the local
vocabularies, the separators (a schema's delimiters), which word and
which separator stand where.  The run's seed makes every word's bytes.
So every seed's records hold the same words in the same places, with
other bytes, and put nearly the same work on the codec (a 1 MiB block's
stream within about 1 % from seed to seed, where a layout of each seed's
own moved a 1 MiB wave's time by up to 16 %).

Parameters (the traffic file): ``vocab``, ``word_lens`` [lo, hi],
``local``, ``segment_words``, ``separators``, ``epoch_segments``,
``batch_segments``, ``layout_seed``.
"""

from __future__ import annotations

import numpy as np


def make(p: dict, nbytes: int, seed: int) -> bytes:
    vlo, vhi = p["word_lens"]
    vocab, local, seg_words = p["vocab"], p["local"], p["segment_words"]
    seps, epoch = p["separators"], p["epoch_segments"]
    seg = p["batch_segments"]
    lay = p["layout_seed"]
    lens = np.random.default_rng((lay, 0)).integers(vlo, vhi + 1, vocab)
    table = np.random.default_rng((seed, 0)).integers(
        0, 0xF0, (vocab, vhi + 2), dtype=np.uint8)
    out, size, k = [], 0, 0
    while size < nbytes:
        # segments k * seg onwards, from generators of their own
        layout = np.random.default_rng((lay, 1, k))
        loc = layout.integers(0, vocab, (seg, local))
        ids = np.take_along_axis(
            loc, layout.integers(0, local, (seg, seg_words)), 1)
        sepb = np.random.default_rng((lay, 2, k)).integers(
            0xF0, 0x100, (seg // epoch, seps, 2), dtype=np.uint8)
        sep = sepb[np.arange(seg)[:, None] // epoch,
                   layout.integers(0, seps, (seg, seg_words))]
        ids, sep = ids.ravel(), sep.reshape(-1, 2)
        rows = table[ids]
        nb = lens[ids]
        at = np.arange(len(ids))
        rows[at, nb] = sep[:, 0]
        rows[at, nb + 1] = sep[:, 1]
        keep = np.arange(rows.shape[1])[None, :] < (nb + 2)[:, None]
        out.append(rows[keep].tobytes())
        size += len(out[-1])
        k += 1
    return b"".join(out)[:nbytes]
