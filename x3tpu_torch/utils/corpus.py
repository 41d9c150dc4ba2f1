"""The corpus of the MB checks: inputs of 256 KiB to 32 MiB whose streams
are recorded once (``tools/mb_oracle.py`` writes their lengths and sha256
from the JAX package's host codec into ``x3tpu_torch/testdata/
mb_streams.json``) and held against the kernels' streams on the card
(``chip_smoke.py``), where the JAX package is not run.

The corpus is a numpy-seeded binary section of 31.75 MiB followed by files
of the checkout that the port never edits (the JAX package's sources, its
native codec and the golden inputs), read as bytes and sorted by path.  So
a recorded stream stays valid from one commit to the next.  The documents
and the tests, which change with every commit, are left out.  It needs a
checkout of the repository: an installed package has none of these files.

The binary section is records, each a word and a 2-byte separator.  The
words are random strings of 2-5 bytes below 0xF0 from a vocabulary of
VOCAB; every segment of SEGMENT_WORDS records draws its words from LOCAL
of them, so each word repeats more than -t 15 times inside an 8 KiB
window and becomes a dictionary entry, and the vocabulary turns over from
segment to segment as in a file of many sections.  The separators, 4 per
epoch of EPOCH_SEGMENTS segments (about 256 KiB), are bytes from 0xF0 up:
a separator's context row holds the words that follow it.  At -t 15 -w 8
a 1 MiB block of it needs 7 300-9 700 dictionary entries and ctx1 rows of
2 100-3 900 items, the first 4 MiB 20 903 entries (x3tpu.host.
measure_state); the 16 KiB blocks of the source text need a few hundred.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
SOURCES = ("x3tpu/**/*.py", "native/*.cpp", "tests/golden/*.bin")
SEEDED_BYTES = 31 * 2**20 + 3 * 2**18   # the binary section, 31.75 MiB
VOCAB = 20000            # the words
WORD_LENS = (2, 5)       # a word's bytes, inclusive
LOCAL = 40               # the words of one segment
SEGMENT_WORDS = 745      # records a segment (about 4 KiB)
SEPARATORS = 4           # separators an epoch
EPOCH_SEGMENTS = 64      # segments an epoch
BATCH_SEGMENTS = 256     # segments generated together (about 1 MiB)


def source_paths() -> list:
    """The files the corpus reads, sorted by path."""
    paths = set()
    for pattern in SOURCES:
        paths.update(ROOT.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"mb_corpus: no source files under {ROOT}")
    return sorted(paths)


@functools.lru_cache(maxsize=4)
def _vocab(seed: int):
    rng = np.random.default_rng((seed, 0))
    lens = rng.integers(WORD_LENS[0], WORD_LENS[1] + 1, VOCAB)
    words = rng.integers(0, 0xF0, (VOCAB, WORD_LENS[1] + 2), dtype=np.uint8)
    return lens, words


@functools.lru_cache(maxsize=64)
def _batch(seed: int, k: int) -> bytes:
    """Segments k * BATCH_SEGMENTS onwards, from a generator of their own,
    so that any prefix of the section is made without the rest."""
    lens, words = _vocab(seed)
    rng = np.random.default_rng((seed, 1, k))
    seg, n = BATCH_SEGMENTS, SEGMENT_WORDS
    local = rng.integers(0, VOCAB, (seg, LOCAL))
    ids = np.take_along_axis(local, rng.integers(0, LOCAL, (seg, n)), 1)
    epochs = seg // EPOCH_SEGMENTS
    seps = rng.integers(0xF0, 0x100, (epochs, SEPARATORS, 2), dtype=np.uint8)
    sep = seps[np.arange(seg)[:, None] // EPOCH_SEGMENTS,
               rng.integers(0, SEPARATORS, (seg, n))]
    ids, sep = ids.ravel(), sep.reshape(-1, 2)
    rows = words[ids]
    n_bytes = lens[ids]
    at = np.arange(len(ids))
    rows[at, n_bytes] = sep[:, 0]
    rows[at, n_bytes + 1] = sep[:, 1]
    keep = np.arange(rows.shape[1])[None, :] < (n_bytes + 2)[:, None]
    return rows[keep].tobytes()


def _seeded(nbytes: int, seed: int) -> bytes:
    out, size, k = [], 0, 0
    while size < nbytes:
        out.append(_batch(seed, k))
        size += len(out[-1])
        k += 1
    return b"".join(out)[:nbytes]


def mb_corpus(nbytes: int, seed: int = 0) -> bytes:
    """``nbytes`` of the corpus, at most SEEDED_BYTES plus the sources.  A
    shorter corpus is a prefix of a longer one of the same seed, so the
    blocks of a wave are slices of one input."""
    data = _seeded(min(nbytes, SEEDED_BYTES), seed)
    if nbytes > SEEDED_BYTES:
        data += b"".join(p.read_bytes() for p in source_paths())
        if len(data) < nbytes:
            raise ValueError(f"mb_corpus: {nbytes} bytes asked for, the "
                             f"corpus has {len(data)}")
    return data[:nbytes]


# The inputs whose streams tools/mb_oracle.py records, by name: (block
# bytes, blocks, window) under X3Params(window=window) (-t 15).  Each set
# is mb_corpus(block bytes x blocks) cut into blocks.  chip_smoke.py runs
# the waves and the file on the card; the CPU tests run the two core sets
# (tests/test_torch_mb.py).
MB_SETS = {
    "wave_1m": (1 << 20, 32, 8192),      # 32 x 1 MiB; the 32 MiB container
    "wave_w32": (256 << 10, 32, 32768),  # 32 x 256 KiB at -w 32
    "file_4m": (4 << 20, 1, 8192),       # one 4 MiB file, one raw stream
    "core_256k": (256 << 10, 1, 8192),
    "core_w32": (64 << 10, 1, 32768),
}
ORACLE = ROOT / "x3tpu_torch" / "testdata" / "mb_streams.json"


def mb_blocks(name: str) -> list:
    """The blocks of set ``name`` (:data:`MB_SETS`)."""
    block, count, _ = MB_SETS[name]
    data = mb_corpus(block * count)
    return [data[i * block : (i + 1) * block] for i in range(count)]


# The warm-start reference (tools/mb_oracle.py --warm records it in
# WARM_ORACLE): WARM_BLOCKS blocks of WARM_BLOCK bytes, the head of
# mb_corpus, at -t 15 -w 8, every block from the seeds and the tape that
# compress(warm_start=True) trains on them (WARM_SEEDS seeds on
# warm_sample's strided sample).
WARM_BLOCK, WARM_BLOCKS, WARM_SEEDS = 16 << 10, 8, 256
WARM_ORACLE = ROOT / "x3tpu_torch" / "testdata" / "warm_streams.json"


def warm_blocks() -> list:
    """The blocks of the warm-start reference."""
    data = mb_corpus(WARM_BLOCK * WARM_BLOCKS)
    return [data[i * WARM_BLOCK : (i + 1) * WARM_BLOCK]
            for i in range(WARM_BLOCKS)]


def warm_sample(blocks, seed_sample: int = 64 * 1024) -> bytes:
    """compress's training sample of ``blocks``: the head of each block,
    ``seed_sample // len(blocks)`` bytes (x3tpu_torch/parallel/runtime.py
    compress)."""
    per = max(seed_sample // len(blocks), 1)
    return b"".join(b[:per] for b in blocks)


def warm_digests(seed_bytes, tape) -> dict:
    """sha256 of trained seeds (each a length byte and its bytes, as the
    container stores them) and of a tape's container bytes."""
    import hashlib

    from x3tpu_torch import warm

    seeds = b"".join(bytes([len(s)]) + bytes(s) for s in seed_bytes)
    return {"seeds_sha256": hashlib.sha256(seeds).hexdigest(),
            "tape_sha256": hashlib.sha256(
                warm.encode_tape(list(tape))).hexdigest()}


def load_oracle() -> dict:
    """mb_streams.json: set name -> {"window", "block_bytes", "streams":
    [{"len", "sha256"}, ...]} (one entry a block, in order)."""
    import json

    return json.loads(ORACLE.read_text())["sets"]
