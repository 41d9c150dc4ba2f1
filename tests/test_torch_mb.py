"""MB blocks and 32 KiB windows on the CPU: the g++ cores of the CUDA
kernels at ``caps_for_block`` of 64-256 KiB against x3tpu's native host
codec; the plain codec at a 32 KiB window against x3tpu's XLA engine; the
launches a wave is cut into when its lanes do not fit the device's memory
(``mesh.launch_lanes``), which change no output; the Python copy of
the kernels' scratch layout; and the recorded MB streams
(``x3tpu_torch/testdata/mb_streams.json``) that ``chip_smoke.py`` holds
the kernels to on the card."""

import dataclasses
import functools
import hashlib
import types

import numpy as np
import pytest
import torch

from x3tpu import host, spec
from x3tpu_torch import codec
from x3tpu_torch.config import CodecCaps, X3Params
from x3tpu_torch.parallel import mesh as meshmod
from x3tpu_torch.parallel import runtime
from x3tpu_torch.utils import corpus
from x3tpu_torch.vm import driver

from test_torch_codec import (TINY_CAPS, TINY_PARAMS, _assert_same,
                              _tiny_blocks, _xla, jax_twin)
from test_torch_codec import one_thread  # noqa: F401  (autouse)
from test_torch_decode import pack_streams
from test_torch_kernel_host import _decode, _encode, core  # noqa: F401

# the capacities of the MB regime, with a lane's scratch in MiB (one
# decimal) as x3_core.cuh make_layout gives it
LAYOUT_CASES = {
    "16 KiB": (runtime.caps_for_block(16 << 10), 12.4),
    "256 KiB": (runtime.caps_for_block(256 << 10), 520.2),
    "1 MiB": (runtime.caps_for_block(1 << 20), 522.3),
    "4 MiB": (runtime.caps_for_block(4 << 20), 522.3),
    "16 MiB": (runtime.caps_for_block(16 << 20), 428.3),
    "1 MiB, -w 32": (runtime.caps_for_block(1 << 20, window=32768), 64.4),
}
# the most items caps_for_block gives a context row at dict_cap 8192 and
# below (x3tpu's VM promoted-row capacity, rows.py BIG1)
ITEMS_SMALL_DICT = runtime.caps_for_block(128 << 10).ctx_items_cap


def _caps_args(caps):
    return (caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
            caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows)


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
def test_layout_matches_host_build(core, name):
    """The Python layout (what launch_lanes counts, without the CUDA
    library) equals the host build's make_layout, and so the kernels'."""
    caps, mib = LAYOUT_CASES[name]
    words = driver.scratch_words(caps)
    assert words == core.x3h_scratch_words(*_caps_args(caps))
    assert round(4 * words / 2**20, 1) == mib
    assert driver.dict_layout(caps, core, "x3h_dict_layout") == (
        driver.dict_layout(caps))


class _Kernels:
    """The kernels' layout queries, answered by the host build (or, with
    ``extra``, off by that many words)."""

    def __init__(self, core, extra=0):
        self.core, self.extra = core, extra

    def x3_scratch_words(self, *caps):
        return self.core.x3h_scratch_words(*caps) + self.extra

    def x3_dict_layout(self, *args):
        self.core.x3h_dict_layout(*args)


def test_kernel_layout_guard(core):
    """driver.kernel_layout sizes and seeds every launch from the kernel
    library's own layout, and raises where the Python copy differs."""
    caps = runtime.caps_for_block(1 << 20)
    words, offsets = driver.kernel_layout(caps, _Kernels(core))
    assert words == driver.scratch_words(caps)
    assert offsets == driver.dict_layout(caps)
    with pytest.raises(RuntimeError, match="dict_cap=24576"):
        driver.kernel_layout(caps, _Kernels(core, extra=1))


@functools.lru_cache(maxsize=None)
def _host_stream(name):
    """x3tpu.host.encode of the first block of corpus set ``name``."""
    _, _, window = corpus.MB_SETS[name]
    return host.encode(corpus.mb_blocks(name)[0],
                       jax_twin(X3Params(window=window)))


def _entry(stream):
    return {"len": len(stream), "sha256": hashlib.sha256(stream).hexdigest()}


@pytest.mark.parametrize("name", ["core_256k", "core_w32"])
def test_core_mb_block_matches_host(core, name):
    """K1's and K2's cores on one block of the MB corpus at the block's
    caps_for_block (dict 16384, 8192 ctx1 items at 256 KiB and -w 8; dict
    4096 at 64 KiB and -w 32): the reference stream, and back.  At 256 KiB
    the lane's scratch shows a promoted ctx1 row of more than 640 items,
    the most a row holds at dict_cap 8192 and below."""
    block_bytes, _, window = corpus.MB_SETS[name]
    block = corpus.mb_blocks(name)[0]
    params = X3Params(window=window)
    caps = runtime.caps_for_block(block_bytes, window=window)
    scratch = np.zeros(driver.scratch_words(caps), np.int32)
    words, lens, counts, _, flags = _encode(core, [block], params, caps,
                                            "scratch", scratch=scratch)
    assert not flags.any()
    stream = words[0].tobytes()[: lens[0]]
    assert stream == _host_stream(name)
    assert _entry(stream) == corpus.load_oracle()[name]["streams"][0]
    f1 = driver.layout(caps)["f1"]
    big_n = scratch[f1["big_n"] : f1["big_n"] + caps.ctx_promo_rows]
    if name == "core_256k":
        assert big_n.max() > ITEMS_SMALL_DICT == 640, big_n.max()
    out, out_lens, dcounts, _, dflags = _decode(
        core, *pack_streams([stream]), caps)
    assert not dflags.any()
    assert out[0, : out_lens[0]].tobytes() == block
    np.testing.assert_array_equal(dcounts, counts)


def test_plain_window_32k_matches_xla():
    """The plain codec at a 32 KiB window, the largest, on two blocks
    smaller than it (tests/test_vm.py test_vm_window_32k_small_block):
    x3tpu's XLA engine lane for lane, and the spec's streams."""
    params = X3Params(max_match_count=15, window=32 * 1024)
    caps = CodecCaps(dict_cap=256, pair_cap=512, ctx_items_cap=128,
                     ctx0_items_cap=128, ctx_small_cap=16, block_bytes=1024)
    blocks = [b"abcabcabc 0123456789 " * 40, bytes(range(128)) * 2]
    text, tlen = codec.pack_blocks(blocks, params, caps)
    ours = codec.encode_blocks_chunked(torch.from_numpy(text),
                                       torch.from_numpy(tlen), params, caps)
    assert not ours[4].any_flag().any()
    _assert_same(ours, _xla(blocks, params, caps), slice(None))
    for stream, b in zip(codec.streams_from_words(ours[0], ours[1], 2),
                         blocks):
        assert stream == spec.encode(b, jax_twin(params))


def _counting(monkeypatch, name):
    """Count the calls of codec.``name`` (one a launch on the CPU)."""
    calls = []
    fn = getattr(codec, name)

    def counted(*args, **kwargs):
        calls.append(len(args[1]))
        return fn(*args, **kwargs)

    monkeypatch.setattr(codec, name, counted)
    return calls


def _same_result(a, b):
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    for f in codec.Overflow._fields:
        assert torch.equal(getattr(a[4], f), getattr(b[4], f)), f


# tests/test_vm.py's blocks cut to 600 bytes, at capacities where every
# overflow flag fires on some lane but not on all
SPLIT_CAPS = dataclasses.replace(TINY_CAPS, dict_cap=64, pair_cap=128,
                                 block_bytes=600)


@functools.lru_cache(maxsize=None)
def _split_inputs():
    """(text, tlen, the plain encoder's one-launch result)."""
    blocks = [b[:600] for b in _tiny_blocks()]
    text, tlen = codec.pack_blocks(blocks, TINY_PARAMS, SPLIT_CAPS)
    return text, tlen, codec.encode_blocks_chunked(
        torch.from_numpy(text), torch.from_numpy(tlen), TINY_PARAMS,
        SPLIT_CAPS)


def test_launch_split_encode(monkeypatch):
    """A budget of three lanes cuts seven lanes into three launches, whose
    joined words, lengths, counts, sizes and overflow flags (each flag
    fires on some lanes) are one launch's."""
    text, tlen, one = _split_inputs()
    per = driver.encoder_lane_bytes(TINY_PARAMS, SPLIT_CAPS)
    calls = _counting(monkeypatch, "encode_blocks_chunked")
    got = meshmod.encode_sharded(text, tlen, TINY_PARAMS, SPLIT_CAPS,
                                 meshmod.single(torch.device("cpu")), None,
                                 3 * per)
    assert calls == [3, 3, 1]
    _same_result(got, one)
    for f in codec.Overflow._fields:
        assert 0 < int(getattr(got[4], f).sum()) < len(tlen), f


def test_launch_split_decode(monkeypatch):
    """The same for the decoder, on those streams (truncated where the
    output buffer overflowed)."""
    one = _split_inputs()[2]
    words = one[0].numpy().astype(np.uint32)
    byte_lens = one[1].numpy().astype(np.int32)
    ref = codec.decode_blocks_chunked(one[0], one[1], SPLIT_CAPS)
    per = driver.decoder_lane_bytes(SPLIT_CAPS, words.shape[1])
    calls = _counting(monkeypatch, "decode_blocks_chunked")
    got = meshmod.decode_sharded(words, byte_lens, SPLIT_CAPS,
                                 meshmod.single(torch.device("cpu")), None,
                                 3 * per)
    assert calls == [3, 3, 1]
    _same_result(got, ref)


def test_launch_split_wave_round_trip(monkeypatch):
    """encode_wave and decode_wave with a budget of one lane a launch: two
    launches each way, the host codec's streams, and the blocks back."""
    data = corpus.mb_corpus(600)
    params = X3Params(max_match_count=4, window=256)
    caps = CodecCaps(dict_cap=256, pair_cap=1024, ctx_items_cap=64,
                     block_bytes=300)
    parts = [data[:300], data[300:]]
    enc_calls = _counting(monkeypatch, "encode_blocks_chunked")
    res = runtime.encode_wave(
        parts, params, caps, device="cpu",
        mem_budget=driver.encoder_lane_bytes(params, caps))
    assert enc_calls == [1, 1]
    assert res.payloads == [host.encode(p, jax_twin(params)) for p in parts]
    dec_calls = _counting(monkeypatch, "decode_blocks_chunked")
    iw = pack_streams(res.payloads)[0].shape[1]
    back = runtime.decode_wave(
        res.payloads, [300, 300], caps, device="cpu",
        mem_budget=2 * driver.decoder_lane_bytes(caps, iw) - 1)
    assert dec_calls == [1, 1]
    assert back.payloads == parts


def test_retry_grows_the_promoted_row_pool(monkeypatch):
    """A block with more context rows past ctx_small_cap items than
    ctx_promo_rows overflows at any capacities CodecCaps.scaled gives,
    which keep the pool; the waves' retries double the pool with the rest:
    the host codec's stream after two retries, and the block back."""
    block = corpus.mb_corpus(600)
    params = X3Params()
    caps = CodecCaps(dict_cap=512, pair_cap=2048, ctx_items_cap=128,
                     ctx0_items_cap=128, ctx_small_cap=2, ctx_promo_rows=4,
                     block_bytes=600)
    text, tlen = codec.pack_blocks([block], params, caps.scaled(8))
    stuck = codec.encode_blocks_chunked(torch.from_numpy(text),
                                        torch.from_numpy(tlen), params,
                                        caps.scaled(8))
    assert stuck[4].ctx0.any()
    calls = _counting(monkeypatch, "encode_blocks_chunked")
    res = runtime.encode_wave([block], params, caps, device="cpu")
    assert len(calls) == 3
    assert res.payloads == [host.encode(block, jax_twin(params))]
    dec_calls = _counting(monkeypatch, "decode_blocks_chunked")
    back = runtime.decode_wave(res.payloads, [600], caps, device="cpu")
    assert back.payloads == [block] and len(dec_calls) > 1


def test_one_lane_over_budget_raises():
    """A lane that does not fit raises, naming its caps and bytes; nothing
    is clamped."""
    caps = runtime.caps_for_block(1 << 20)
    need = driver.encoder_lane_bytes(X3Params(), caps)
    with pytest.raises(meshmod.LaunchMemoryError,
                       match="dict_cap=24576") as e:
        meshmod.launch_lanes(need, caps, torch.device("cpu"), need - 1)
    assert str(need) in str(e.value)
    assert meshmod.launch_lanes(need, caps, torch.device("cpu"), need) == 1


def test_launch_lanes_default_is_a_share_of_total_memory(monkeypatch):
    """On a card the default budget is MEM_SHARE of its total memory (not
    of its free memory), so the count is the same on every run: 113 lanes
    of caps_for_block(1 MiB) on an 80 GB card, 57 and 28 after one and
    two retries."""
    props = types.SimpleNamespace(total_memory=85_045_116_928)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    caps = runtime.caps_for_block(1 << 20)
    cuda = torch.device("cuda", 0)
    for c, want in ((caps, 113), (caps.scaled(2), 57), (caps.scaled(4), 28)):
        got = meshmod.launch_lanes(driver.encoder_lane_bytes(X3Params(), c),
                                   c, cuda)
        assert got == want, (c, got)
    assert meshmod.launch_lanes(1, caps, torch.device("cpu")) >= 1 << 20


def test_corpus_reads_no_moving_files():
    """mb_corpus reads the JAX package's sources, its native codec and the
    golden inputs, never the documents or the tests, which change with
    every commit; a shorter corpus is a prefix of a longer one."""
    paths = corpus.source_paths()
    assert paths and all(p.suffix in (".py", ".cpp", ".bin") for p in paths)
    rel = {p.relative_to(corpus.ROOT).parts[0] for p in paths}
    assert rel == {"x3tpu", "native", "tests"}
    assert all(p.parent.name == "golden" for p in paths
               if p.relative_to(corpus.ROOT).parts[0] == "tests")
    assert corpus.mb_corpus(1 << 20).startswith(corpus.mb_corpus(300_000))


def test_oracle_smallest_entry():
    """The smallest recorded stream, recomputed with x3tpu.host.encode."""
    sets = corpus.load_oracle()
    assert set(sets) == set(corpus.MB_SETS)
    name = min(sets, key=lambda n: corpus.MB_SETS[n][0])
    assert sets[name]["streams"][0] == _entry(_host_stream(name))


@pytest.mark.slow
def test_oracle_all_entries():
    """Every recorded stream, recomputed (several minutes)."""
    sets = corpus.load_oracle()
    for name, (block_bytes, count, window) in corpus.MB_SETS.items():
        assert sets[name]["block_bytes"] == block_bytes
        assert sets[name]["window"] == window
        params = jax_twin(X3Params(window=window))
        for i, block in enumerate(corpus.mb_blocks(name)):
            assert sets[name]["streams"][i] == _entry(
                host.encode(block, params)), (name, i)
