"""The CUDA kernels' per-lane cores (``x3tpu_torch/csrc/x3_core.cuh`` for
the encoder K1, ``x3_dec_core.cuh`` for the decoder K2) built for the host
with g++, one thread per lane, and held against the golden streams and the
plain PyTorch encoder and decoder.  This is the only route to the kernels'
logic without a GPU; no module of the package uses this build.  The
encoder runs with its planes in the scratch and, as K1's shared memory
holds them, in a buffer of their own (``driver.smem_plan``)."""

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from x3tpu import host
from x3tpu_torch import codec
from x3tpu_torch.config import X3Params
from x3tpu_torch.parallel import runtime
from x3tpu_torch.vm import driver

from conftest import GOLDEN, PARAMSETS, golden_cases
from test_torch_codec import (OVERFLOW_FLAGS, SMALL_CAPS, SMALL_PARAMS,
                              TINY_CAPS, TINY_PARAMS, _tiny_blocks, jax_twin,
                              plain_tiny)
from test_torch_codec import one_thread  # noqa: F401  (autouse)
from test_torch_decode import (CORRUPT_CAPS, corrupt_streams, pack_streams,
                               plain_corrupt, plain_decode,
                               plain_tiny_decoded)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "x3tpu_torch" / "csrc"
FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]


@pytest.fixture(scope="module")
def core():
    """The host build, made once per source hash and renamed into place."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    src = CSRC / "x3_core_host.cpp"
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = ROOT / "build" / "x3tpu_torch" / f"libx3core_host_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x3h_encode.argtypes = ([p, p, i, ctypes.c_longlong] + [i] * 12
                               + [ctypes.c_uint, p, p, i] + [p] * 6)
    lib.x3h_encode.restype = i
    lib.x3h_scratch_words.argtypes = [i] * 6
    lib.x3h_scratch_words.restype = ctypes.c_longlong
    lib.x3h_smem_layout.argtypes = ([i] * 6 + [ctypes.c_longlong, ctypes.c_uint]
                                    + [p])
    lib.x3h_smem_layout.restype = None
    lib.x3h_window_counts.argtypes = [p, i, i, p]
    lib.x3h_window_counts.restype = None
    lib.x3h_decode.argtypes = [p, p] + [i] * 9 + [p, p, i] + [p] * 5
    lib.x3h_dict_layout.argtypes = [i] * 6 + [p]
    lib.x3h_dict_layout.restype = None
    lib.x3h_seed_scratch.argtypes = [i] * 6 + [p, p, i, i, p]
    lib.x3h_seed_scratch.restype = None
    lib.x3h_decode.restype = i
    u = ctypes.c_uint
    lib.x3h_ix_search.argtypes = [p, p, i, i, u, p]
    lib.x3h_ix_search.restype = None
    lib.x3h_row_search.argtypes = [p, p, i, u, p]
    lib.x3h_row_search.restype = None
    lib.x3h_small_search.argtypes = [p, u, p]
    lib.x3h_small_search.restype = None
    lib.x3h_probe_pair.argtypes = [p, p, i, i, i, ctypes.c_longlong, p, p,
                                   i, p]
    lib.x3h_probe_pair.restype = ctypes.c_longlong
    lib.x3h_ix_tree.argtypes = [i, i, i, p, p, p, p]
    lib.x3h_ix_tree.restype = ctypes.c_longlong
    return lib


# where the encoder core keeps its planes: all in the scratch, or those of
# K1's plan in a buffer of their own
PLACEMENTS = ("scratch", "shared")


def _seed_args(seeds):
    """(strs pointer, lens pointer, K, the arrays) of the host core's seed
    arguments; None: no seeds."""
    if seeds is None:
        return None, None, 0, ()
    strs = np.ascontiguousarray(seeds[0], np.uint8)
    lens = np.ascontiguousarray(seeds[1], np.int32)
    return strs.ctypes.data, lens.ctypes.data, len(lens), (strs, lens)


def _encode(lib, blocks, params, caps, placement, seeds=None, scratch=None):
    """The host core's (words, byte_lens, counts, sizes, flags) as arrays;
    every lane starts from ``seeds`` (strs u8 [K, 32], lens i32 [K]) where
    given; the last lane's final scratch is copied into ``scratch`` (i32
    [driver.scratch_words(caps)]) where given."""
    sp, lp, k, _keep = _seed_args(seeds)
    mask = driver.smem_plan(params, caps).mask if placement == "shared" else 0
    text, tlen = codec.pack_blocks(blocks, params, caps)
    lanes = len(blocks)
    words = np.zeros((lanes, caps.out_words), np.uint32)
    lens = np.zeros(lanes, np.int32)
    counts = np.zeros((lanes, 5), np.int32)
    sizes = np.zeros((lanes, 5), np.float32)
    flags = np.zeros(lanes, np.int32)
    rc = lib.x3h_encode(
        text.ctypes.data, tlen.ctypes.data, lanes, text.shape[1],
        params.max_match_count, params.window, params.magic_factor1,
        params.magic_factor2, int(params.nl_remap), caps.dict_cap,
        caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
        caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words, mask,
        sp, lp, k, words.ctypes.data, lens.ctypes.data, counts.ctypes.data,
        sizes.ctypes.data, flags.ctypes.data,
        None if scratch is None else scratch.ctypes.data)
    assert rc == 0
    return words, lens, counts, sizes, flags


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("pname", sorted(PARAMSETS))
def test_core_golden_streams(core, pname, placement):
    names = [n for n, p in golden_cases() if p == pname]
    blocks = [(GOLDEN / f"{n}.bin").read_bytes() for n in names]
    words, lens, _, _, flags = _encode(core, blocks, X3Params(**PARAMSETS[pname]),
                                       SMALL_CAPS, placement)
    assert not flags.any()
    for i, name in enumerate(names):
        got = words[i].tobytes()[: lens[i]]
        assert got == (GOLDEN / f"{name}.{pname}.x3").read_bytes(), name


@pytest.mark.parametrize("placement", PLACEMENTS)
def test_core_matches_plain_with_overflow(core, placement):
    """Every output against the plain encoder, at capacities where the
    dictionary, both context families, the pair map and the output buffer
    overflow: the kernel's flag bits (x3_core.cuh OF_*) are x3tpu's
    Overflow fields, and the words of the lanes beside the one that
    overflows its buffer are untouched."""
    plain = plain_tiny()
    words, lens, counts, sizes, flags = _encode(core, _tiny_blocks(),
                                                TINY_PARAMS, TINY_CAPS,
                                                placement)
    np.testing.assert_array_equal(words.astype(np.int64), plain[0].numpy())
    np.testing.assert_array_equal(lens, plain[1].numpy())
    np.testing.assert_array_equal(counts, plain[2].numpy())
    np.testing.assert_allclose(sizes, plain[3].numpy(), rtol=1e-5, atol=1e-3)
    for bit, name in enumerate(OVERFLOW_FLAGS):
        fired = (flags >> bit) & 1 == 1
        np.testing.assert_array_equal(fired, getattr(plain[4], name).numpy(),
                                      err_msg=name)
        assert fired.any(), name


def _window_counts_bytewise(text, p, W):
    """backend.c:66-74 byte by byte: count[i] = positions s in [p+1,
    p+W-32) whose next i+1 bytes repeat those at p."""
    counts = np.zeros(32, np.int32)
    for s in range(p + 1, p + W - 32):
        r = 0
        while r < 32 and text[s + r] == text[p + r]:
            r += 1
        counts[:r] += 1
    return counts


@pytest.mark.parametrize("kind", ["text", "runs", "random", "zeros"])
def test_core_window_counts_match_bytewise(core, kind):
    """The core's word-wide window scan (four positions a word pair, long
    runs compared on, the last position p+W-33 included) counts as the
    byte loop does, at every alignment of p."""
    rng = np.random.default_rng(3)
    W = 256
    if kind == "text":
        body = (GOLDEN / "text_small.bin").read_bytes()[:700]
    elif kind == "runs":
        body = b"".join(b" " * int(n) + b"x" for n in rng.integers(0, 40, 60))
    elif kind == "random":
        body = rng.integers(0, 4, 700, np.uint8).tobytes()
    else:
        body = bytes(700)
    text = np.zeros(len(body) + W + 64, np.uint8)
    text[: len(body)] = np.frombuffer(body, np.uint8)
    out = np.zeros(32, np.int32)
    for p in range(0, len(body) - W // 2, 37):
        core.x3h_window_counts(text.ctypes.data, p, W, out.ctypes.data)
        np.testing.assert_array_equal(out, _window_counts_bytewise(text, p, W),
                                      err_msg=f"p={p}")


CAPS_16K = runtime.caps_for_block(16 * 1024)
SMEM_BUDGET = driver.SMEM_BLOCK_MAX - driver.SMEM_STATIC


def test_smem_plan_at_16k_holds_every_plane():
    """The main path's caps: every hot plane in shared memory, within what
    a block may have."""
    plan = driver.smem_plan(X3Params(), CAPS_16K)
    assert list(plan.offsets) == list(driver.SMEM_PLANES)
    assert plan.nbytes <= SMEM_BUDGET
    assert plan.nbytes + driver.SMEM_STATIC <= driver.SMEM_BLOCK_MAX


def test_smem_plan_big_dictionary_stays_global():
    """Above driver.SMEM_DICT_MAX entries (dict_cap 2048 up, where
    all-global measured faster) every plane stays in global memory: at
    dict_cap 8192 and at the MB caps no plane moves, though some fit."""
    for caps in (dataclasses.replace(CAPS_16K, dict_cap=8192),
                 dataclasses.replace(CAPS_16K, dict_cap=2048),
                 runtime.caps_for_block(1 << 20),
                 runtime.caps_for_block(256 << 10, window=32768)):
        plan = driver.smem_plan(X3Params(), caps)
        assert plan.offsets == {} and plan.nbytes == 0 and plan.mask == 0
    edge = dataclasses.replace(CAPS_16K, dict_cap=driver.SMEM_DICT_MAX)
    assert "strs" in driver.smem_plan(X3Params(), edge).offsets


@pytest.mark.parametrize("caps", [
    CAPS_16K, dataclasses.replace(CAPS_16K, dict_cap=8192),
    CAPS_16K.scaled(2), CAPS_16K.scaled(4), TINY_CAPS,
], ids=["16k", "dict8192", "16k_x2", "16k_x4", "tiny"])
def test_smem_plan_matches_core_layout(core, caps):
    """The plan's offsets and size are the core's own (x3_core.cuh
    place_smem, exported by the host build)."""
    params = X3Params()
    plan = driver.smem_plan(params, caps)
    out = np.zeros(len(driver.SMEM_PLANES) + 1, np.int64)
    core.x3h_smem_layout(caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
                         caps.ctx0_items_cap, caps.ctx_small_cap,
                         caps.ctx_promo_rows, codec.text_bytes(params, caps),
                         plan.mask, out.ctypes.data)
    want = [plan.offsets.get(n, -1) for n in driver.SMEM_PLANES]
    assert out.tolist() == want + [plan.nbytes]


def _decode(lib, words, byte_lens, caps, seeds=None):
    """The host decoder core's (out, out_lens, counts, sizes, flags), every
    lane from the encoder's ``seeds`` where given."""
    sp, lp, k, _keep = _seed_args(seeds)
    words = np.ascontiguousarray(words, np.uint32)
    byte_lens = np.ascontiguousarray(byte_lens, np.int32)
    lanes, iw = words.shape
    out = np.zeros((lanes, caps.block_bytes), np.uint8)
    lens = np.zeros(lanes, np.int32)
    counts = np.zeros((lanes, 5), np.int32)
    sizes = np.zeros((lanes, 5), np.float32)
    flags = np.zeros(lanes, np.int32)
    rc = lib.x3h_decode(
        words.ctypes.data, byte_lens.ctypes.data, lanes, iw, caps.block_bytes,
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
        caps.ctx_small_cap, caps.ctx_promo_rows, sp, lp, k, out.ctypes.data,
        lens.ctypes.data, counts.ctypes.data, sizes.ctypes.data,
        flags.ctypes.data)
    assert rc == 0
    return out, lens, counts, sizes, flags


OF_STEPS = 32    # x3_core.cuh: a lane past the event bound
OF_CORRUPT = 64  # x3_core.cuh: a symbol value past its model's total


@pytest.mark.parametrize("pname", sorted(PARAMSETS))
def test_core_decodes_golden_streams(core, pname):
    names = [n for n, p in golden_cases() if p == pname]
    words, byte_lens = pack_streams(
        [(GOLDEN / f"{n}.{pname}.x3").read_bytes() for n in names])
    out, lens, _, _, flags = _decode(core, words, byte_lens, SMALL_CAPS)
    assert not flags.any()
    for i, name in enumerate(names):
        assert out[i, : lens[i]].tobytes() == (
            GOLDEN / f"{name}.bin").read_bytes(), name


def test_core_decode_matches_plain_with_overflow(core):
    """plain_tiny()'s streams at TINY_CAPS (the dictionary, both context
    families and the pair map overflow; lane 3's stream is cut short):
    every output equals the plain decoder's, flag bits included."""
    words, byte_lens = plain_tiny()[:2]
    plain = plain_tiny_decoded()
    out, lens, counts, sizes, flags = _decode(core, words.numpy(),
                                              byte_lens.numpy(), TINY_CAPS)
    np.testing.assert_array_equal(out, plain[0].numpy())
    np.testing.assert_array_equal(lens, plain[1].numpy())
    np.testing.assert_array_equal(counts, plain[2].numpy())
    np.testing.assert_allclose(sizes, plain[3].numpy(), rtol=1e-5, atol=1e-3)
    for bit, name in enumerate(OVERFLOW_FLAGS):
        np.testing.assert_array_equal((flags >> bit) & 1 == 1,
                                      getattr(plain[4], name).numpy(),
                                      err_msg=name)
    assert not (flags & OF_STEPS).any()


@pytest.mark.parametrize("name", sorted(corrupt_streams()))
def test_core_corrupt_stream_matches_plain(core, name):
    """The corrupt streams end as they do in the plain decoder: a symbol
    past its model's total (OF_CORRUPT) or the event bound (OF_STEPS), both
    "malformed", or the same flags or length."""
    words, byte_lens = pack_streams([corrupt_streams()[name]])
    _, lens, _, _, flags = _decode(core, words, byte_lens, CORRUPT_CAPS)
    if flags[0] & (OF_STEPS | OF_CORRUPT):
        got = "malformed"
    else:
        got = tuple(n for b, n in enumerate(OVERFLOW_FLAGS)
                    if flags[0] >> b & 1) or int(lens[0])
    assert got == plain_corrupt(name)


@pytest.mark.parametrize("block", [256, 255])
def test_core_decode_write_at_buffer_edge(core, block):
    """As tests/test_torch_decode.py: the core keeps the last byte of a
    write that ends at the buffer's end, and equals the plain decoder
    one byte short of it."""
    data = (b"edge case payload " * 16)[:256]
    words, byte_lens = pack_streams([host.encode(data,
                                                 jax_twin(SMALL_PARAMS))])
    caps = dataclasses.replace(CORRUPT_CAPS, block_bytes=block)
    out, lens, _, _, flags = _decode(core, words, byte_lens, caps)
    plain = plain_decode(words, byte_lens, caps)
    np.testing.assert_array_equal(out, plain[0].numpy())
    assert lens[0] == plain[1][0] and bool(flags[0] & 16) == bool(plain[4].out[0])
    if block == len(data):
        assert out[0].tobytes() == data


# The decoder's warp-wide symbol searches (x3_dec_core.cuh), as the host
# build runs them (32 lanes in one thread), against the serial searches of
# x3tpu's decoder, at every value from 0 to two past the model's total.


@pytest.mark.parametrize("ixn", [0, 1, 2, 31, 32, 33, 1023, 1024])
def test_core_ix_search_matches_decode_search(core, ixn):
    """The index model kept as an inclusive cumulative sum over its ixn
    live entries (ixn: the dictionary's size, or 1 where a corrupt stream
    hit entry 0 of an empty dictionary): ix_search's symbol, low, span and
    tag equal decode_search(ix, D, by_freq=True) and tag_of[sym], values
    at or past the total included."""
    D = 1024
    rng = np.random.default_rng(100 + ixn)
    ix = np.zeros(D, np.int32)
    ix[:ixn] = rng.integers(1, 9, ixn)
    tag_of = rng.permutation(D).astype(np.int32)
    out = np.zeros(8, np.int32)
    for value in range(int(ix.sum()) + 3):
        core.x3h_ix_search(ix.ctypes.data, tag_of.ctypes.data, D, ixn, value,
                           out.ctypes.data)
        assert out[:4].tolist() == out[4:].tolist(), f"value {value}"


@pytest.mark.parametrize("n", [0, 1, 16, 32, 33, 256, 1024, 1500])
def test_core_row_search_matches_decode_search(core, n):
    """A context row of n live items (16 small, 256 big, up to 1024 a hub,
    and past it): chunk_bases' total is the row's sum, and wsearch's
    symbol, low, span and tag equal decode_search(row, n, by_freq=False)
    and the tag at sym (zero freqs included)."""
    rng = np.random.default_rng(200 + n)
    f = rng.integers(0, 6, max(n, 1)).astype(np.int32)
    tags = rng.integers(0, 1 << 20, max(n, 1)).astype(np.int32)
    out = np.zeros(10, np.int32)
    for value in range(int(f[:n].sum()) + 3):
        core.x3h_row_search(f.ctypes.data, tags.ctypes.data, n, value,
                            out.ctypes.data)
        assert out[:5].tolist() == out[5:].tolist(), f"value {value}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_core_char_and_length_search_match_small_decode(core, seed):
    """The literal path's models, whose freqs are at least 1: char_search
    (256 entries, 8 a lane) and lane_search (32, one a lane) equal
    small_decode."""
    rng = np.random.default_rng(300 + seed)
    f = rng.integers(1, 1 + 4 ** (seed + 1), 256).astype(np.int32)
    out = np.zeros(12, np.int32)
    for value in range(int(f.sum()) + 3):
        core.x3h_small_search(f.ctypes.data, value, out.ctypes.data)
        assert out[:3].tolist() == out[3:6].tolist(), f"char, value {value}"
        if value <= int(f[:32].sum()) + 2:
            assert out[6:9].tolist() == out[9:].tolist(), f"length, {value}"


# K1's hash index of the dictionary (x3_core.cuh) against the scan it
# replaced (K2's probe), on the same entries.

def _probe_dict(rng, text, n, seeds=0, dups=0):
    """n distinct entries (strs u8 [n, 32], lens i32 [n]) of every length
    1-32: about half the text's own substrings, many a prefix of the one
    before, as the encoder inserts them (the row the 32 bytes of the text
    from the entry's start), the rest random bytes; the first ``seeds``
    zero-padded past their length, as a seeded start's, the last ``dups``
    of them copies of earlier seeds."""
    strs = np.zeros((n, 32), np.uint8)
    lens = np.zeros(n, np.int32)
    keys, e, tries = set(), 0, 0
    while e < n:
        length = e + 1 if e < 32 else int(rng.integers(1, 33))
        if e % 4 == 3 and lens[e - 1] > 1 and not tries:
            row, length = strs[e - 1], lens[e - 1] - 1
        elif e % 2:
            row = rng.integers(0, 4, 32, np.uint8)
        else:
            at = int(rng.integers(0, len(text) - 96))
            row = text[at: at + 32]
        key = row[:length].tobytes()
        tries += 1
        if key in keys:
            continue
        keys.add(key)
        strs[e], lens[e] = row, length
        e, tries = e + 1, 0
    strs[:seeds][np.arange(32) >= lens[:seeds, None]] = 0
    for e in range(seeds - dups, seeds):
        src = int(rng.integers(0, seeds - dups))
        strs[e], lens[e] = strs[src], lens[src]
    return strs, lens


# case: (entries, dict_cap, seeded entries, index slots (0: the caps'),
# duplicate seeds, targets at the text's end)
PROBE_CASES = {
    "random": (3000, 4096, 0, 0, 0, False),
    "dict_1024": (1000, 1024, 0, 0, 0, False),
    "collide_wrap": (100, 4096, 0, 128, 0, False),
    "seeded": (1500, 4096, 600, 0, 40, False),
    "full": (4096, 4096, 0, 0, 0, False),
    "padded_end": (2000, 4096, 0, 0, 0, True),
}


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_core_hash_probe_matches_scan(core, name):
    """The index's probe and veto probe (x3_core.cuh hash_probe,
    hash_probe_len), built as K1 builds it (a seeded start's entries at
    once before the first event, the rest one an event), give the scan's
    okmask, longest length and its tag, and the veto's probe that length,
    at every target: with every length, with entries that prefix one
    another, at the 16 KiB caps' dict_cap 1024, in a table small enough
    that chains collide and wrap around its end, from seeds that hold a
    string twice, with the dictionary full, and at the text's zero-padded
    end."""
    n, dict_cap, seeds, slots, dups, at_end = PROBE_CASES[name]
    rng = np.random.default_rng(sorted(PROBE_CASES).index(name))
    body = rng.integers(0, 4, 3000, np.uint8)
    text = np.concatenate([body, np.zeros(64, np.uint8)])
    strs, lens = _probe_dict(rng, text, n, seeds, dups)
    if at_end:   # entries running into the padding
        for e in range(32, 64):
            k = int(rng.integers(1, 31))
            strs[e] = text[len(body) - k: len(body) - k + 32]
            lens[e] = k + int(rng.integers(1, 33 - k))
        pos = np.arange(len(body) - 40, len(body), dtype=np.int32)
    else:
        pos = rng.integers(0, len(body), 400).astype(np.int32)
    out = np.zeros((len(pos), 8), np.int32)
    visits = core.x3h_probe_pair(
        strs.ctypes.data, lens.ctypes.data, n, dict_cap, seeds, slots,
        text.ctypes.data, pos.ctypes.data, len(pos), out.ctypes.data)
    np.testing.assert_array_equal(out[:, 4:], out[:, :4])
    assert (out[:, 1] > 0).mean() > 0.4 and (out[:, 3] > 0).mean() > 0.4
    assert (np.bitwise_count(out[:, 0].astype(np.uint32)) > 1).any()
    chain = visits / (2 * 32 * len(pos))   # two probes of 32 lookups a target
    # the slots a lookup reads: near linear probing's mean for a miss at
    # the table's load (keys hashed evenly), and more than two where the
    # table is nearly full
    load = n / (slots or driver.hash_slots(
        dataclasses.replace(CAPS_16K, dict_cap=dict_cap)))
    assert chain > 2 if name == "collide_wrap" else (
        chain < 1.3 * (1 + 1 / (1 - load) ** 2) / 2), chain


# K1's index model as a Fenwick tree (x3_core.cuh ix_tree_*) against the
# plain sums over its freqs it replaced.

# case: (D, seeds, events, share of events that are new entries, the hit's
# rank: "random", "first" (0) or "last" (dn - 1))
IX_TREE_CASES = {
    "d1024_k0": (1024, 0, 3000, 0.3, "random"),
    "d1024_k600": (1024, 600, 1000, 0.3, "random"),
    "d24576_k0": (24576, 0, 6000, 0.5, "random"),
    "d24576_k600": (24576, 600, 6000, 0.5, "random"),
    "d1024_k600_first": (1024, 600, 1000, 0.3, "first"),
    "d1024_k0_last": (1024, 0, 2000, 0.3, "last"),
    "d1024_k600_full": (1024, 600, 3000, 0.6, "random"),
}


@pytest.mark.parametrize("name", sorted(IX_TREE_CASES))
def test_core_ix_tree_matches_plain_sums(core, name):
    """The index model's tree, built from a seeded start's freqs, then
    given a random mix of new entries and rank gains, each reaching the
    tree an event later as in K1, gives each hit the plain sums over the freqs
    (low below its rank, its span, the total over the live entries): at
    the 16 KiB and 1 MiB caps' dict_cap, with and without seeds, at rank 0
    and rank dn - 1, and with the model full (new entries past D
    dropped)."""
    d, k, n, new, at = IX_TREE_CASES[name]
    rng = np.random.default_rng(sorted(IX_TREE_CASES).index(name))
    is_new = rng.random(n) < new
    idx1 = (rng.random(n) < 0.7).astype(np.int32)
    rank = np.full(n, -1, np.int32)
    dn = k
    for s in range(n):   # a hit's rank among the entries live then
        if not is_new[s] and dn > 0:
            rank[s] = {"random": rng.integers(0, dn), "first": 0,
                       "last": np.iinfo(np.int32).max}[at]  # max: dn - 1
        elif dn < d:
            dn += 1
    out = np.zeros((n, 3), np.int32)
    ix = np.zeros(d, np.int32)
    nodes = core.x3h_ix_tree(d, k, n, rank.ctypes.data, idx1.ctypes.data,
                             out.ctypes.data, ix.ctypes.data)
    want = np.zeros(d, np.int64)
    want[:k] = 1
    dn, hits = k, 0
    for s in range(n):
        if rank[s] >= 0:
            r = min(int(rank[s]), dn - 1)
            assert out[s].tolist() == [want[:r].sum(), want[r],
                                       want[:dn].sum()], (s, r, dn)
            want[r] += idx1[s]
            hits += 1
        else:
            assert not out[s].any()
            if dn < d:
                want[dn] = 1
                dn += 1
    np.testing.assert_array_equal(ix, want)
    assert hits > n // 4 and nodes > hits
    assert dn == d if name.endswith("full") else dn < d
