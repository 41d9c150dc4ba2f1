"""Dictionary seeds in the port, on the CPU: the seed trainer
(``x3tpu_torch.host``, its own copy of ``native/x3host.cpp``'s) against
``x3tpu.host.train_seeds``; the container's seed section against
``x3tpu.parallel.blocks``; the plain codec's seeded start against
``x3tpu.host`` with ``seeds=``; the kernels' seeded start (the g++ build of
their cores, both of K1's placements, and the wrapper's seeding pass)
against the plain codec; and ``compress(dict_seed=True)`` against a
container of x3tpu's host-seeded payloads.  Streams, counts and flags
exact; sizes within rtol 1e-5, atol 1e-3 (x3tpu's tolerance between its
engines, tests/test_vm.py)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from x3tpu import host as jhost
from x3tpu.parallel import blocks as jblk
from x3tpu_torch import codec, host
from x3tpu_torch.config import X3Params
from x3tpu_torch.parallel import blocks as blk
from x3tpu_torch.parallel import runtime
from x3tpu_torch.vm import driver

from conftest import GOLDEN, PARAMSETS
from test_torch_codec import jax_twin
from test_torch_codec import one_thread  # noqa: F401  (autouse)
from test_torch_decode import pack_streams
from test_torch_kernel_host import PLACEMENTS, _decode, _encode, core  # noqa: F401

PARAMS = X3Params(**PARAMSETS["t4_w1"])
BLOCK = 1024
DATA = (GOLDEN / "text_small.bin").read_bytes()[: 4 * BLOCK]


@functools.lru_cache(maxsize=None)
def seeded_job(nbytes=len(DATA)):
    """compress(dict_seed=True)'s blocks, seeds and caps for DATA's first
    nbytes, built the way x3tpu/parallel/runtime.py:591-605 builds them,
    with x3tpu's trainer: (blocks, seed strings, (strs, lens), caps)."""
    parts = blk.split_blocks(DATA[:nbytes], BLOCK)
    caps = runtime.caps_for_block(BLOCK, window=PARAMS.window)
    per = 64 * 1024 // len(parts)
    strs, lens = jhost.train_seeds(b"".join(p[:per] for p in parts),
                                   jax_twin(PARAMS), min(256, caps.dict_cap // 2),
                                   ranked=True)
    seed_bytes = [bytes(strs[i, : lens[i]]) for i in range(len(lens))]
    return parts, seed_bytes, runtime.seeds_to_arrays(seed_bytes), caps


@functools.lru_cache(maxsize=None)
def plain_seeded():
    """The plain encoder's seeded result on the job's blocks, and the plain
    decoder's on its streams."""
    parts, _, seeds, caps = seeded_job()
    text, tlen = codec.pack_blocks(parts, PARAMS, caps)
    enc = codec.encode_blocks_chunked(torch.from_numpy(text),
                                      torch.from_numpy(tlen), PARAMS, caps,
                                      seeds)
    streams = codec.streams_from_words(enc[0], enc[1], len(parts))
    words, byte_lens = pack_streams(streams)
    dec = codec.decode_blocks_chunked(
        torch.from_numpy(words.astype(np.int64)),
        torch.from_numpy(byte_lens), caps, seeds)
    return enc, streams, dec


@pytest.mark.parametrize("name", ["text_small", "c_source", "binary_mixed"])
@pytest.mark.parametrize("pname", ["t15_w8", "t2_w1_x", "t8_w2_m0"])
def test_trainer_matches_host(name, pname):
    """The port's trainer gives x3tpu's usage-ranked seeds."""
    data = (GOLDEN / f"{name}.bin").read_bytes()
    params = X3Params(**PARAMSETS[pname])
    strs, lens = host.train_seeds(data, params, 64)
    jstrs, jlens = jhost.train_seeds(data, jax_twin(params), 64, ranked=True)
    np.testing.assert_array_equal(lens, jlens)
    for i, n in enumerate(lens):
        assert strs[i, :n].tobytes() == jstrs[i, :n].tobytes(), i
        assert not strs[i, n:].any()   # zero-padded


def test_seed_section_matches_x3tpu():
    """A container with the trained seeds: the port writes x3tpu's bytes
    and reads x3tpu's seeds back, and seeds_to_arrays gives the arrays."""
    _, seed_bytes, (strs, lens), _ = seeded_job()
    payloads, lens_in = [b"\x01\x02\x03\x04", b"abcdefgh"], [7, 9]
    ours = blk.pack_container(payloads, lens_in, BLOCK, seeds=seed_bytes)
    theirs = jblk.pack_container(payloads, lens_in, BLOCK, seeds=seed_bytes)
    assert ours == theirs
    assert blk.unpack_container(theirs)[3] == seed_bytes
    assert [len(s) for s in seed_bytes] == lens.tolist()
    for i, s in enumerate(seed_bytes):
        assert strs[i, : len(s)].tobytes() == s and not strs[i, len(s):].any()


def test_plain_seeded_matches_host():
    """The plain codec's seeded start: 4 x 1 KiB blocks encode to
    x3tpu.host.encode(block, seeds=)'s streams and decode back, the
    decoder's event counts equal to the encoder's."""
    parts, _, seeds, _ = seeded_job()
    enc, streams, dec = plain_seeded()
    for part, stream in zip(parts, streams):
        assert stream == jhost.encode(part, jax_twin(PARAMS), seeds=seeds)
    out, out_lens, counts = dec[0], dec[1], dec[2]
    for i, part in enumerate(parts):
        assert out[i, : out_lens[i]].numpy().tobytes() == part
    np.testing.assert_array_equal(counts.numpy(), enc[2].numpy())
    assert not enc[4].any_flag().any() and not dec[4].any_flag().any()


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_core_seeded_matches_plain(core, placement):  # noqa: F811
    """The g++ build of K1's core, seeded, with its planes in the scratch
    and in a buffer of their own (the seeded planes then copied in, as K1's
    shared memory takes them): streams, counts and flags equal the plain
    encoder's, sizes within the tolerance; K2's core decodes them to the
    plain decoder's bytes, counts and sizes."""
    parts, _, seeds, caps = seeded_job()
    enc, streams, dec = plain_seeded()
    words, lens, counts, sizes, flags = _encode(core, parts, PARAMS, caps,
                                                placement, seeds)
    np.testing.assert_array_equal(words.astype(np.int64), enc[0].numpy())
    np.testing.assert_array_equal(lens, enc[1].numpy())
    np.testing.assert_array_equal(counts, enc[2].numpy())
    np.testing.assert_allclose(sizes, enc[3].numpy(), rtol=1e-5, atol=1e-3)
    assert not flags.any()
    w, bl = pack_streams(streams)
    out, out_lens, dcounts, dsizes, dflags = _decode(core, w, bl, caps, seeds)
    np.testing.assert_array_equal(out, dec[0].numpy())
    np.testing.assert_array_equal(out_lens, dec[1].numpy())
    np.testing.assert_array_equal(dcounts, dec[2].numpy())
    np.testing.assert_allclose(dsizes, dec[3].numpy(), rtol=1e-5, atol=1e-3)
    assert not dflags.any()


def test_core_seeded_hash_index_matches_plain(core):  # noqa: F811
    """The same seeded job at dict_cap 4096, the caps of a 64 KiB block,
    whose K1 lanes index the seeds in a hash index four times the size
    before the first event: the plain encoder's streams (which no capacity
    without an overflow changes), counts and sizes, and K2's core decodes
    them back."""
    parts, _, seeds, caps = seeded_job()
    caps = dataclasses.replace(caps, dict_cap=4096)
    enc, streams, _ = plain_seeded()
    words, lens, counts, sizes, flags = _encode(core, parts, PARAMS, caps,
                                                "scratch", seeds)
    assert [words[i].tobytes()[: lens[i]] for i in range(len(parts))] == (
        streams)
    np.testing.assert_array_equal(counts, enc[2].numpy())
    np.testing.assert_allclose(sizes, enc[3].numpy(), rtol=1e-5, atol=1e-3)
    assert not flags.any()
    w, bl = pack_streams(streams)
    out, out_lens, _, _, dflags = _decode(core, w, bl, caps, seeds)
    for i, part in enumerate(parts):
        assert out[i, : out_lens[i]].tobytes() == part
    assert not dflags.any()


@pytest.mark.parametrize("cumulative", [False, True])
def test_wrapper_seeding_matches_core(core, cumulative):  # noqa: F811
    """driver.seed_scratch (the wrappers' one seeding pass, in PyTorch) at
    the layout query's offsets writes what the cores' seed_dict writes:
    the index model as freqs for K1, as their cumulative sum for K2."""
    _, _, seeds, caps = seeded_job()
    args = (caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
            caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows)
    offsets = driver.dict_layout(caps, core, "x3h_dict_layout")
    nwords = offsets["ix"] + caps.dict_cap
    scratch = torch.zeros((2, nwords), dtype=torch.int32)
    driver.seed_scratch(scratch, offsets, seeds, cumulative)
    ref = np.zeros(nwords + 64, np.int32)   # the core writes only these
    strs = np.ascontiguousarray(seeds[0])
    core.x3h_seed_scratch(*args, strs.ctypes.data, seeds[1].ctypes.data,
                          len(seeds[1]), int(cumulative), ref.ctypes.data)
    for lane in range(2):
        np.testing.assert_array_equal(scratch[lane].numpy(), ref[:nwords])


def test_compress_dict_seed_matches_x3tpu_container():
    """compress(dict_seed=True) on the CPU is byte for byte the container
    of x3tpu's host-seeded payloads (x3tpu's trainer, x3tpu's
    pack_container), and decompress reads x3tpu's container back."""
    data = DATA[: 2 * BLOCK]
    parts, seed_bytes, seeds, _ = seeded_job(len(data))
    payloads = [jhost.encode(p, jax_twin(PARAMS), seeds=seeds) for p in parts]
    theirs = jblk.pack_container(payloads, [len(p) for p in parts], BLOCK,
                                 seeds=seed_bytes)
    assert runtime.compress(data, PARAMS, block_bytes=BLOCK, dict_seed=True,
                            device="cpu") == theirs
    assert runtime.decompress(theirs, device="cpu") == data


def test_more_seeds_than_dict_cap_raise():
    """More seeds than dict_cap raise, in the plain codec and before the
    wrappers build anything."""
    _, _, seeds, caps = seeded_job()
    small = dataclasses.replace(caps, dict_cap=len(seeds[1]) - 1)
    text, tlen = codec.pack_blocks([b"abc"], PARAMS, small)
    with pytest.raises(ValueError, match="seeds"):
        codec.encode_blocks_chunked(text, tlen, PARAMS, small, seeds)
    with pytest.raises(ValueError, match="seeds"):
        driver._seeded_scratch(1, small, "cpu", seeds, False)


def test_single_block_with_dict_seed_stays_raw():
    """A single block is never seeded: the output is its raw stream."""
    data = DATA[:300]
    out = runtime.compress(data, PARAMS, dict_seed=True, device="cpu")
    assert out == jhost.encode(data, jax_twin(PARAMS))
    assert not blk.is_container(out)
