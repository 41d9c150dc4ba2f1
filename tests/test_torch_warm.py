"""Model warm start in the port, on the CPU: ``x3tpu_torch.warm`` (tape
bytes, replay, packing, fit checks) against ``x3tpu.warm``; the trainer's
tape (``x3tpu_torch.host.train_tape``) against ``x3tpu.host.train_tape``;
the container's tape section against ``x3tpu.parallel.blocks``; the plain
codec's warm start against ``x3tpu.host.encode(..., warm_tape=)``; the
kernels' warm start (the g++ build of their cores, both of K1's
placements, from the scratch ``driver.warm_scratch`` writes) against the
plain codec; ``compress(warm_start=True)`` against a container of x3tpu's
warm payloads; a warm wave over a CPU mesh; and one entry of the recorded
reference ``x3tpu_torch/testdata/warm_streams.json``.  Streams, counts and
flags exact; sizes within rtol 1e-5, atol 1e-3 (x3tpu's tolerance between
its engines, tests/test_vm.py)."""

import ctypes
import dataclasses
import functools
import hashlib
import json

import numpy as np
import pytest
import torch

from x3tpu import host as jhost
from x3tpu import warm as jwarm
from x3tpu.config import X3Params as JX3Params
from x3tpu.parallel import blocks as jblk
from x3tpu_torch import codec, host, warm
from x3tpu_torch.config import X3Params
from x3tpu_torch.parallel import blocks as blk
from x3tpu_torch.parallel import mesh as meshmod
from x3tpu_torch.parallel import runtime
from x3tpu_torch.utils import corpus
from x3tpu_torch.vm import driver

from conftest import GOLDEN, PARAMSETS
from test_torch_codec import jax_twin
from test_torch_codec import one_thread  # noqa: F401  (autouse)
from test_torch_decode import pack_streams
from test_torch_kernel_host import PLACEMENTS, core  # noqa: F401

PARAMS = X3Params(**PARAMSETS["t4_w1"])
BLOCK = 1024
DATA = (GOLDEN / "text_small.bin").read_bytes()[: 4 * BLOCK]
R = warm.RESET
# tests/test_warm.py's tapes (over their seed counts) and a cut tape
TAPES = {
    "collapse": ([R, 3, 1, R, R, 2, 2, R], 8),
    "contexts": ([5, 7, 5, R, 7, 5], 8),
    "row cap": ([x for t in range(1, warm.ROW_CAP + 6) for x in (1, t)],
                warm.ROW_CAP + 7),
}


@functools.lru_cache(maxsize=None)
def warm_job(nbytes=len(DATA)):
    """compress(warm_start=True)'s blocks, seeds, tape and caps for DATA's
    first nbytes, built the way x3tpu/parallel/runtime.py:591-620 builds
    them, with x3tpu's trainer: (blocks, seed strings, (strs, lens),
    canonical tape, the port's WarmArrays, caps)."""
    parts = blk.split_blocks(DATA[:nbytes], BLOCK)
    caps = runtime.caps_for_block(BLOCK, window=PARAMS.window)
    strs, lens, tape = jhost.train_tape(
        corpus.warm_sample(parts), jax_twin(PARAMS),
        min(256, caps.dict_cap // 2))
    seed_bytes = [bytes(strs[i, : lens[i]]) for i in range(len(lens))]
    tape, _ = warm.decode_tape(warm.encode_tape(tape))
    wa = warm.pack(warm.replay(tape, len(seed_bytes)))
    return (parts, seed_bytes, runtime.seeds_to_arrays(seed_bytes), tape,
            wa, caps)


@functools.lru_cache(maxsize=None)
def plain_warm():
    """The plain encoder's warm result on the job's blocks, its streams,
    and the plain decoder's result on them."""
    parts, _, seeds, _, wa, caps = warm_job()
    text, tlen = codec.pack_blocks(parts, PARAMS, caps)
    enc = codec.encode_blocks_chunked(torch.from_numpy(text),
                                      torch.from_numpy(tlen), PARAMS, caps,
                                      seeds, wa)
    streams = codec.streams_from_words(enc[0], enc[1], len(parts))
    words, byte_lens = pack_streams(streams)
    dec = codec.decode_blocks_chunked(
        torch.from_numpy(words.astype(np.int64)),
        torch.from_numpy(byte_lens), caps, seeds, wa)
    return enc, streams, dec


def _arrays_equal(ours, theirs):
    for f in ("hub0_tags", "hub0_freqs", "hub1_tags", "hub1_freqs",
              "hub1_pairs", "ctx0_idx", "ctx1_idx", "pair_n"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)
    for f in ("ctx0_items", "ctx1_items"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("case", sorted(TAPES) + ["trained"])
def test_warm_module_matches_x3tpu(case):
    """Tape bytes, their reading back, the replay, the packed arrays, the
    dense tables and check_fits' refusals are x3tpu.warm's."""
    if case == "trained":
        _, seed_bytes, _, tape, _, _ = warm_job()
        tape, k = list(tape), len(seed_bytes)
    else:
        tape, k = TAPES[case]
    data = warm.encode_tape(tape)
    assert data == jwarm.encode_tape(tape)
    assert warm.decode_tape(data) == jwarm.decode_tape(data)
    for cut in (data[:-1], data[:3]):
        if len(cut) < len(data):
            with pytest.raises(ValueError):
                warm.decode_tape(cut)
    canon = warm.decode_tape(data)[0]
    ours, theirs = warm.replay(canon, k), jwarm.replay(canon, k)
    assert (ours.pairs, ours.ctx0, ours.ctx1) == (theirs.pairs, theirs.ctx0,
                                                  theirs.ctx1)
    wa, jwa = warm.pack(ours), jwarm.pack(theirs)
    _arrays_equal(wa, jwa)
    dense, xla = warm.dense(wa, 16), jwarm.to_xla_dense(jwa, 16)
    for fam, hub in (("h0", "h0"), ("h1", "h1")):
        for key in ("t", "f", "p") if fam == "h1" else ("t", "f"):
            np.testing.assert_array_equal(dense[fam][key], xla[hub + key])
        assert dense[fam]["n"] == xla[hub + "n"]
    for pool in ("c0", "c1"):
        for key in xla[pool]:
            np.testing.assert_array_equal(dense[pool][key], xla[pool][key],
                                          err_msg=f"{pool} {key}")
    assert dense["pair_n"] == xla["pair_n"]
    for caps in ((1024, 16384, 16, 1024), (k, 16384, 16, 1024),
                 (1024, max(wa.pair_n - 1, 0), 16, 1024),
                 (1024, 16384, 8, 1024), (1024, 16384, 16, 2)):
        outcome = []
        for fits, arrays in ((warm.check_fits, wa), (jwarm.check_fits, jwa)):
            try:
                fits(arrays, *caps)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], caps
    with pytest.raises(ValueError):
        warm.replay([k], k)


@pytest.mark.parametrize("name", ["text_small", "c_source", "binary_mixed"])
@pytest.mark.parametrize("pname", ["t15_w8", "t2_w1_x", "t8_w2_m0"])
def test_train_tape_matches_host(name, pname):
    """The port's trainer gives x3tpu's seeds and tape."""
    data = (GOLDEN / f"{name}.bin").read_bytes()
    params = X3Params(**PARAMSETS[pname])
    strs, lens, tape = host.train_tape(data, params, 64)
    jstrs, jlens, jtape = jhost.train_tape(data, jax_twin(params), 64)
    np.testing.assert_array_equal(lens, jlens)
    for i, n in enumerate(lens):
        assert strs[i, :n].tobytes() == jstrs[i, :n].tobytes(), i
    assert tape == jtape and R in tape
    s2, l2 = host.train_seeds(data, params, 64)   # the same seeds
    np.testing.assert_array_equal(s2, strs)
    np.testing.assert_array_equal(l2, lens)
    assert host.train_tape(data, params, 64, tape_cap=7)[2] == tape[:7]


def test_tape_section_matches_x3tpu():
    """A container with seeds and a tape: the port writes x3tpu's bytes and
    reads x3tpu's tape back; a tape without seeds, or a cut tape, raises."""
    _, seed_bytes, _, tape, _, _ = warm_job()
    payloads, lens_in = [b"\x01\x02\x03\x04", b"abcdefgh"], [7, 9]
    ours = blk.pack_container(payloads, lens_in, BLOCK, seeds=seed_bytes,
                              warm_tape=tape)
    theirs = jblk.pack_container(payloads, lens_in, BLOCK, seeds=seed_bytes,
                                 warm_tape=tape)
    assert ours == theirs
    assert blk.unpack_container(theirs) == jblk.unpack_container(theirs)
    assert blk.unpack_container(theirs)[4] == tape
    with pytest.raises(ValueError, match="requires seeds"):
        blk.pack_container(payloads, lens_in, BLOCK, warm_tape=tape)
    head = len(jblk.pack_container([], [], BLOCK, seeds=seed_bytes))
    with pytest.raises(ValueError):
        blk.unpack_container(theirs[: head + 6])


def test_plain_warm_matches_host():
    """The plain codec's warm start: the blocks encode to
    x3tpu.host.encode(block, seeds=, warm_tape=)'s streams and decode back,
    the decoder's event counts equal to the encoder's; the warm streams
    differ from the seeded ones."""
    parts, _, seeds, tape, _, _ = warm_job()
    enc, streams, dec = plain_warm()
    for part, stream in zip(parts, streams):
        assert stream == jhost.encode(part, jax_twin(PARAMS), seeds=seeds,
                                      warm_tape=tape)
        assert stream != jhost.encode(part, jax_twin(PARAMS), seeds=seeds)
    out, out_lens, counts = dec[0], dec[1], dec[2]
    for i, part in enumerate(parts):
        assert out[i, : out_lens[i]].numpy().tobytes() == part
    np.testing.assert_array_equal(counts.numpy(), enc[2].numpy())
    assert not enc[4].any_flag().any() and not dec[4].any_flag().any()


def _bind_warm(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x3h_fam_layout.argtypes = [i] * 7 + [p]
    lib.x3h_fam_layout.restype = None
    lib.x3h_encode_warm.argtypes = ([p, p, i, ctypes.c_longlong] + [i] * 12
                                    + [ctypes.c_uint, i, p, i, i, i]
                                    + [p] * 5)
    lib.x3h_encode_warm.restype = i
    lib.x3h_decode_warm.argtypes = [p, p] + [i] * 10 + [p, i, i, i] + [p] * 5
    lib.x3h_decode_warm.restype = i
    return lib


def _wrapper_scratch(lib, caps, seeds, wa, cumulative):
    """One lane's scratch as the wrappers start it (``seed_scratch`` and
    ``warm_scratch`` at the host build's layout queries), and the warm
    counts."""
    words = lib.x3h_scratch_words(
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
        caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows)
    scratch = torch.zeros((1, words), dtype=torch.int32)
    driver.seed_scratch(scratch, driver.dict_layout(caps, lib,
                                                    "x3h_dict_layout"),
                        seeds, cumulative)
    counts = driver.warm_scratch(
        scratch, driver.fam_layout(caps, lib, "x3h_fam_layout"), wa, caps)
    return scratch[0].numpy().copy(), counts


def test_warm_scratch_matches_plain_state(core):  # noqa: F811
    """driver.warm_scratch writes, at the host build's family layout (the
    Python copy's), the plain codec's warm start plane for plane: both
    hubs, the ctx1 hub's pairs and the small-pool rows, with nothing
    promoted; its counts are the plain start's."""
    _, _, seeds, _, wa, caps = warm_job()
    lib = _bind_warm(core)
    assert driver.fam_layout(caps, lib, "x3h_fam_layout") == (
        driver.fam_layout(caps))
    scratch, counts = _wrapper_scratch(lib, caps, seeds, wa, False)
    _, ctx0, ctx1, *_ = codec._init_shared(1, caps, "cpu", seeds, wa)
    want = np.zeros_like(scratch)
    driver.seed_scratch(torch.from_numpy(want)[None],
                        driver.dict_layout(caps), seeds, False)
    for fam, state in (("f0", ctx0), ("f1", ctx1)):
        off = driver.fam_layout(caps)[fam]
        for plane in driver.FAM_PLANES:
            vals = getattr(state, plane)
            if vals is None:
                continue
            flat = vals[0].reshape(-1).numpy()
            want[off[plane] : off[plane] + flat.size] = flat
    np.testing.assert_array_equal(scratch, want)
    assert counts == (int(codec._pair_n0(1, "cpu", wa)[0]),
                      int(ctx0.hub_n[0]), int(ctx1.hub_n[0]))
    assert counts[0] > 0 and counts[1] > 0 and counts[2] > 0


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_core_warm_matches_plain(core, placement):  # noqa: F811
    """The g++ build of K1's core from the wrappers' warm scratch, with its
    planes in the scratch and in a buffer of their own (every planned
    plane copied in, the hubs and ctx1 row counts included, as K1's shared
    memory takes them): streams, counts and flags equal the plain
    encoder's, sizes within the tolerance; K2's core decodes them to the
    plain decoder's bytes, counts and sizes."""
    parts, _, seeds, _, wa, caps = warm_job()
    enc, streams, dec = plain_warm()
    lib = _bind_warm(core)
    plan = driver.smem_plan(PARAMS, caps)
    assert {"f1_hub_tags", "f0_hub_tags", "f1_n"} <= set(plan.offsets)
    mask = plan.mask if placement == "shared" else 0
    init, counts = _wrapper_scratch(lib, caps, seeds, wa, False)
    text, tlen = codec.pack_blocks(parts, PARAMS, caps)
    lanes = len(parts)
    words = np.zeros((lanes, caps.out_words), np.uint32)
    lens = np.zeros(lanes, np.int32)
    kcounts = np.zeros((lanes, 5), np.int32)
    sizes = np.zeros((lanes, 5), np.float32)
    flags = np.zeros(lanes, np.int32)
    assert lib.x3h_encode_warm(
        text.ctypes.data, tlen.ctypes.data, lanes, text.shape[1],
        PARAMS.max_match_count, PARAMS.window, PARAMS.magic_factor1,
        PARAMS.magic_factor2, int(PARAMS.nl_remap), caps.dict_cap,
        caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
        caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words, mask,
        len(seeds[1]), init.ctypes.data, *counts, words.ctypes.data,
        lens.ctypes.data, kcounts.ctypes.data, sizes.ctypes.data,
        flags.ctypes.data) == 0
    np.testing.assert_array_equal(words.astype(np.int64), enc[0].numpy())
    np.testing.assert_array_equal(lens, enc[1].numpy())
    np.testing.assert_array_equal(kcounts, enc[2].numpy())
    np.testing.assert_allclose(sizes, enc[3].numpy(), rtol=1e-5, atol=1e-3)
    assert not flags.any()
    w, bl = pack_streams(streams)
    dinit, _ = _wrapper_scratch(lib, caps, seeds, wa, True)
    out = np.zeros((lanes, caps.block_bytes), np.uint8)
    out_lens = np.zeros(lanes, np.int32)
    assert lib.x3h_decode_warm(
        w.ctypes.data, bl.ctypes.data, lanes, w.shape[1], caps.block_bytes,
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
        caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows,
        len(seeds[1]), dinit.ctypes.data, *counts, out.ctypes.data,
        out_lens.ctypes.data, kcounts.ctypes.data, sizes.ctypes.data,
        flags.ctypes.data) == 0
    np.testing.assert_array_equal(out, dec[0].numpy())
    np.testing.assert_array_equal(out_lens, dec[1].numpy())
    np.testing.assert_array_equal(kcounts, dec[2].numpy())
    np.testing.assert_allclose(sizes, dec[3].numpy(), rtol=1e-5, atol=1e-3)
    assert not flags.any()


def test_compress_warm_matches_x3tpu_container():
    """compress(warm_start=True) on the CPU is byte for byte the container
    of x3tpu's warm payloads (x3tpu's trainer, host codec and
    pack_container), and decompress reads x3tpu's container back."""
    data = DATA[: 2 * BLOCK]
    parts, seed_bytes, seeds, tape, _, _ = warm_job(len(data))
    payloads = [jhost.encode(p, jax_twin(PARAMS), seeds=seeds,
                             warm_tape=tape) for p in parts]
    theirs = jblk.pack_container(payloads, [len(p) for p in parts], BLOCK,
                                 seeds=seed_bytes, warm_tape=tape)
    assert runtime.compress(data, PARAMS, block_bytes=BLOCK, warm_start=True,
                            device="cpu") == theirs
    assert runtime.decompress(theirs, device="cpu") == data


def test_warm_wave_over_cpu_mesh():
    """A warm wave over a 2-entry CPU mesh (a pad lane in the second
    group: an empty block encoded and EMPTY_STREAM decoded from the warm
    state) gives x3tpu.host's streams, as one device does
    (test_plain_warm_matches_host), and back."""
    _, _, seeds, tape, wa, caps = warm_job()
    parts = blk.split_blocks(DATA[: 3 * 512], 512)
    two = meshmod.make_mesh(devices=["cpu"] * 2)
    res = runtime.encode_wave(parts, PARAMS, caps, device="cpu", seeds=seeds,
                              mesh=two, warm=wa)
    assert res.payloads == [jhost.encode(p, jax_twin(PARAMS), seeds=seeds,
                                         warm_tape=tape) for p in parts]
    back = runtime.decode_wave(res.payloads, [len(p) for p in parts], caps,
                               device="cpu", seeds=seeds, mesh=two, warm=wa)
    assert back.payloads == parts


def test_warm_refusals():
    """A warm state without seeds, or at capacities that cannot hold it,
    raises in the plain codec and in the wrappers (before they build
    anything, or in the scratch's warm pass)."""
    parts, _, seeds, _, wa, caps = warm_job()
    text, tlen = codec.pack_blocks(parts[:1], PARAMS, caps)
    with pytest.raises(ValueError, match="seeds"):
        codec.encode_blocks_chunked(text, tlen, PARAMS, caps, None, wa)
    with pytest.raises(ValueError, match="seeds"):
        driver._seeded_scratch(1, caps, "cpu", None, False, warm=wa)
    small = dataclasses.replace(caps, pair_cap=wa.pair_n - 1)
    with pytest.raises(ValueError, match="pair capacity"):
        codec.encode_blocks_chunked(text, tlen, PARAMS, small, seeds, wa)
    with pytest.raises(ValueError, match="pair capacity"):
        driver.warm_scratch(torch.zeros((1, driver.scratch_words(small)),
                                        dtype=torch.int32),
                            driver.fam_layout(small), wa, small)


def test_warm_reference_entry():
    """warm_streams.json: the port's trainer gives the recorded seeds and
    tape on corpus.warm_blocks(), and x3tpu.host.encode the recorded
    stream of its first block (chip_smoke.py holds K1 to the file)."""
    ref = json.loads(corpus.WARM_ORACLE.read_text())
    blocks = corpus.warm_blocks()
    assert len(ref["streams"]) == len(blocks) == corpus.WARM_BLOCKS
    strs, lens, tape = host.train_tape(corpus.warm_sample(blocks),
                                       X3Params(), corpus.WARM_SEEDS)
    seed_bytes = [strs[i, : lens[i]].tobytes() for i in range(len(lens))]
    tape, _ = warm.decode_tape(warm.encode_tape(tape))
    digests = corpus.warm_digests(seed_bytes, tape)
    assert digests == {k: ref[k] for k in digests}
    stream = jhost.encode(blocks[0], JX3Params(),
                          seeds=runtime.seeds_to_arrays(seed_bytes),
                          warm_tape=tape)
    assert {"len": len(stream), "sha256": hashlib.sha256(
        stream).hexdigest()} == ref["streams"][0]
