"""The port's copies of x3tpu's framework-free modules against the
originals: the format constants and config dataclasses
(``x3tpu_torch.config``), the X3TC container (``x3tpu_torch.parallel.
blocks``, byte for byte in both directions) and the stats
(``x3tpu_torch.utils.stats``)."""

import dataclasses

import numpy as np
import pytest

from x3tpu import config as jconfig
from x3tpu.parallel import blocks as jblk
from x3tpu.utils import stats as jstats
from x3tpu_torch import config
from x3tpu_torch.parallel import blocks as blk
from x3tpu_torch.utils import stats

from test_torch_codec import jax_twin


def test_config_constants_and_defaults():
    for name in ("MATCH_LOGSIZE", "MAX_MATCH_LEN", "E_CTX0", "E_CTX1",
                 "E_IDX1", "E_NEW", "E_EOF", "E_LAST", "EVENT_INIT_FREQS"):
        assert getattr(config, name) == getattr(jconfig, name), name
    assert dataclasses.asdict(config.X3Params()) == dataclasses.asdict(
        jconfig.X3Params())
    ours = dataclasses.asdict(config.CodecCaps())
    theirs = dataclasses.asdict(jconfig.CodecCaps())
    assert theirs.pop("engine") == "auto" and ours == theirs
    caps = config.CodecCaps(dict_cap=96, block_bytes=1000, out_words_factor=3)
    assert caps.out_words == jax_twin(caps).out_words
    assert jax_twin(caps.scaled(2)) == jax_twin(caps).scaled(2)


PAYLOADS = [b"", b"\xff\x17\x00\x00", bytes(range(256)) * 3, b"x" * 70]


def test_container_bytes_match():
    lens = [0, 0, 768, 5000]
    ours = blk.pack_container(PAYLOADS, lens, 4096)
    theirs = jblk.pack_container(PAYLOADS, lens, 4096)
    assert ours == theirs
    assert blk.unpack_container(theirs) == (PAYLOADS, lens, 4096, [], [])
    assert jblk.unpack_container(ours) == (PAYLOADS, lens, 4096, [], [])
    assert blk.is_container(ours) and not blk.is_container(PAYLOADS[1])
    data = bytes(range(200))
    assert blk.split_blocks(data, 64) == jblk.split_blocks(data, 64)
    assert blk.split_blocks(b"", 64) == jblk.split_blocks(b"", 64)


SEEDS = [b"ab", bytes(range(32)), b"\x00", b"the "]


@pytest.mark.parametrize("case", ["malformed", "seeded", "warm"])
def test_container_errors(case):
    """A cut or padded container raises ValueError in both packages; a
    seeded one (x3tpu's dictionary seeds) parses to x3tpu's seeds, and one
    with a warm-start tape to x3tpu's seeds and tape; the port writes each
    byte for byte, and a cut tape raises ValueError."""
    lens = [1, 2, 3, 4]
    if case == "malformed":
        good = jblk.pack_container(PAYLOADS, lens, 4096)
        for bad in (good[:-1], good + b"\0", good[:10]):
            with pytest.raises(ValueError):
                jblk.unpack_container(bad)
            with pytest.raises(ValueError):
                blk.unpack_container(bad)
    elif case == "seeded":
        theirs = jblk.pack_container(PAYLOADS, lens, 4096, seeds=SEEDS)
        assert blk.unpack_container(theirs) == (PAYLOADS, lens, 4096, SEEDS,
                                                [])
        ours = blk.pack_container(PAYLOADS, lens, 4096, seeds=SEEDS)
        assert ours == theirs
        assert jblk.unpack_container(ours)[3] == SEEDS
        for cut in (len(jblk.pack_container([], [], 4096)) + 3, 30):
            with pytest.raises(ValueError):
                blk.unpack_container(theirs[:cut])
    else:
        warm = jblk.pack_container(PAYLOADS, lens, 4096, seeds=[b"ab"],
                                   warm_tape=[0, 0])
        assert blk.unpack_container(warm) == (PAYLOADS, lens, 4096, [b"ab"],
                                              [0, 0])
        assert blk.pack_container(PAYLOADS, lens, 4096, seeds=[b"ab"],
                                  warm_tape=[0, 0]) == warm
        head = len(jblk.pack_container([], [], 4096, seeds=[b"ab"]))
        with pytest.raises(ValueError):
            blk.unpack_container(warm[: head + 5])


def test_stats_match():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 500, (4, 5))
    sizes = rng.random((4, 5)).astype(np.float32) * 900
    ours = stats.CodecStats.from_arrays(counts, sizes)
    theirs = jstats.CodecStats.from_arrays(counts, sizes)
    ours = ours.merge(stats.CodecStats.zero()).merge(ours)
    theirs = theirs.merge(jstats.CodecStats.zero()).merge(theirs)
    np.testing.assert_array_equal(ours.events, theirs.events)
    np.testing.assert_array_equal(ours.sizes, theirs.sizes)
    assert ours.dict_hits == theirs.dict_hits
    assert ours.estimated_bytes == theirs.estimated_bytes
    assert ours.report(10000, 4000, 0.5) == theirs.report(10000, 4000, 0.5)
