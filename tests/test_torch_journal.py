"""The port's wave journal (``x3tpu_torch.parallel.runtime.WaveJournal``,
``compress(journal_path=)``) on the CPU, mirroring tests/test_parallel.py's
journal tests on one device: a run cut after its first wave resumes to the
container of an uncut run, with the stats of every wave and the seeds it
recorded; a journal written at another wave width is not spliced in."""

import os

import numpy as np
import pytest

from x3tpu_torch.config import CodecCaps, X3Params
from x3tpu_torch.parallel import blocks as blk
from x3tpu_torch.parallel import runtime

from test_torch_codec import one_thread  # noqa: F401  (autouse)

PARAMS = X3Params(max_match_count=4, window=256)
CAPS = CodecCaps(dict_cap=256, pair_cap=2048, ctx_items_cap=64,
                 block_bytes=256)
BLOCK = 160


def _data(seed):
    """Six blocks of text with a few random bytes in each."""
    rng = np.random.default_rng(seed)
    base = b"the quick brown fox jumps over the lazy dog. " * 30
    out = b""
    for i in range(6):
        blk = np.frombuffer(base[i * 7 : i * 7 + BLOCK], np.uint8).copy()
        blk[rng.integers(0, BLOCK, 4)] = rng.integers(0, 256, 4, np.uint8)
        out += blk.tobytes()
    return out


def _cut_after_first_wave(monkeypatch, **kw):
    """A compress with a journal that dies in its second wave."""
    calls = {"n": 0}
    orig = runtime.encode_wave

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("simulated device loss")
        return orig(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(runtime, "encode_wave", flaky)
        with pytest.raises(RuntimeError, match="device loss"):
            runtime.compress(**kw)


def _count_waves(monkeypatch):
    """Count the waves encode_wave runs from here on."""
    calls = {"n": 0}
    orig = runtime.encode_wave

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(runtime, "encode_wave", counted)
    return calls


@pytest.mark.parametrize("dict_seed", [False, True])
def test_journal_resume(tmp_path, monkeypatch, dict_seed):
    """Cut after the first of three waves, then resumed: the container is
    the uncut run's, its stats cover the journal's wave too, only the two
    missing waves are encoded, the seeds come from the journal (the
    trainer is not run again), and the journal is removed."""
    data = _data(3)
    jpath = str(tmp_path / "job.journal")
    kw = dict(data=data, params=PARAMS, block_bytes=BLOCK, caps=CAPS,
              lanes_per_device=2, dict_seed=dict_seed, seed_k=32,
              device="cpu")
    full_stats: list = []
    full = runtime.compress(stats_out=full_stats, **kw)
    assert bool(blk.unpack_container(full)[3]) == dict_seed
    _cut_after_first_wave(monkeypatch, journal_path=jpath, **kw)
    assert os.path.exists(jpath)

    from x3tpu_torch import host

    def no_training(*a, **k):
        raise AssertionError("the seeds were trained again")

    monkeypatch.setattr(host, "train_seeds", no_training)
    waves = _count_waves(monkeypatch)
    resumed_stats: list = []
    resumed = runtime.compress(journal_path=jpath, stats_out=resumed_stats,
                               **kw)
    assert resumed == full
    assert waves["n"] == 2
    np.testing.assert_array_equal(resumed_stats[0].events,
                                  full_stats[0].events)
    np.testing.assert_array_equal(resumed_stats[0].sizes,
                                  full_stats[0].sizes)
    assert not os.path.exists(jpath)
    assert runtime.decompress(resumed, device="cpu") == data


def test_journal_wave_width_mismatch(tmp_path, monkeypatch):
    """A journal written at two lanes a wave is not spliced into a run at
    three (the blocks of a wave differ): the fingerprint covers the width,
    so the run encodes every wave again and gives the right container."""
    data = _data(5)
    jpath = str(tmp_path / "job.journal")
    kw = dict(data=data, params=PARAMS, block_bytes=BLOCK, caps=CAPS,
              device="cpu")
    _cut_after_first_wave(monkeypatch, journal_path=jpath,
                          lanes_per_device=2, **kw)
    waves = _count_waves(monkeypatch)
    resumed = runtime.compress(journal_path=jpath, lanes_per_device=3, **kw)
    assert waves["n"] == 2   # both three-lane waves, none from the journal
    assert resumed == runtime.compress(lanes_per_device=3, **kw)
    assert not os.path.exists(jpath)
    assert runtime.decompress(resumed, device="cpu") == data


def test_journal_of_another_job_starts_over(tmp_path):
    """A journal file of another job, or one that does not parse, is
    started afresh under this job's fingerprint."""
    path = tmp_path / "job.journal"
    path.write_text("not a journal\n")
    j = runtime.WaveJournal(str(path), "abc")
    assert j.done == {} and j.seed_bytes is None
    j.record_seeds([b"ab", b"c"])
    j.record(0, [b"\x00\x01", b""], runtime.CodecStats.zero())
    again = runtime.WaveJournal(str(path), "abc")
    assert again.seed_bytes == [b"ab", b"c"]
    assert again.done[0][0] == [b"\x00\x01", b""]
    other = runtime.WaveJournal(str(path), "xyz")
    assert other.done == {} and other.seed_bytes is None
    assert runtime.WaveJournal(str(path), "abc").done == {}
    other.finish()
    assert not path.exists()
