"""The port's plain PyTorch encoder (``x3tpu_torch.codec``, the plain
version of the CUDA kernel) against x3tpu's XLA engine, the golden streams
of the reference binary, the spec oracle's counters, and the native host
codec's pair count.  Words, lengths, counts and overflow flags must be
equal; the f32 size estimates agree within rtol 1e-5, atol 1e-3 (x3tpu's
own tolerance between its engines, tests/test_vm.py)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x3tpu import codec as jcodec
from x3tpu import config as jconfig
from x3tpu import host, spec
from x3tpu_torch import codec
from x3tpu_torch.config import CodecCaps, X3Params

from conftest import GOLDEN, PARAMSETS, golden_cases

SMALL_CAPS = CodecCaps(
    dict_cap=1 << 10,
    pair_cap=1 << 13,
    ctx_items_cap=192,
    block_bytes=1 << 15,
)
SMALL_PARAMS = X3Params(max_match_count=4, window=1024)
assert SMALL_PARAMS == X3Params(**PARAMSETS["t4_w1"])

# small enough that the dictionary, both context families, the pair map
# and the output buffer (out_words = block_bytes / 4 at factor 1) overflow
# on some of _tiny_blocks()
TINY_CAPS = CodecCaps(dict_cap=128, pair_cap=256, ctx_items_cap=24,
                      ctx0_items_cap=24, ctx_small_cap=8, ctx_promo_rows=4,
                      block_bytes=1200, out_words_factor=1)
TINY_PARAMS = X3Params(max_match_count=4, window=256)
# events per x3tpu chunk at tiny caps (the lockstep test's chunk too, so
# that one process compiles that program once)
TINY_CHUNK = 120
OVERFLOW_FLAGS = ("dict", "ctx0", "ctx1", "pairs", "out")

GOLDEN_NAMES = sorted(p.stem for p in GOLDEN.glob("*.bin"))


def jax_twin(obj):
    """x3tpu's X3Params or CodecCaps built from the fields of the port's
    (the two packages' frozen dataclasses never compare equal, so each
    package gets its own)."""
    cls = {X3Params: jconfig.X3Params, CodecCaps: jconfig.CodecCaps}[type(obj)]
    return cls(**dataclasses.asdict(obj))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's checks run on one torch thread: their tensors are small,
    and the suite's other workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xla_inputs():
    """tests/test_codec_jax.py's batch."""
    return [
        b"",
        b"A",
        b"abracadabra " * 40,
        bytes(range(256)) * 3,
        np.random.default_rng(0).integers(0, 256, 1500, dtype=np.uint8).tobytes(),
        (GOLDEN / "text_small.bin").read_bytes(),
    ]


def _vm_blocks():
    """tests/test_vm.py's batch."""
    golden = (GOLDEN / "text_small.bin").read_bytes()
    rng = np.random.default_rng(7)
    return [
        b"abracadabra " * 40,
        b"",
        golden[:1200],
        rng.integers(0, 256, 400, np.uint8).tobytes(),
        b"A",
        b"\x00" * 1200,
    ]


def _tiny_blocks():
    """tests/test_vm.py's batch with, between two of its lanes, random bytes
    whose stream outgrows the output buffer at TINY_CAPS."""
    blocks = _vm_blocks()
    rng = np.random.default_rng(8)
    blocks.insert(3, rng.integers(0, 256, 900, np.uint8).tobytes())
    return blocks


def _plain(blocks, params, caps):
    text, tlen = codec.pack_blocks(blocks, params, caps)
    return codec.encode_blocks_chunked(text, tlen, params, caps)


@functools.lru_cache(maxsize=None)
def plain_tiny():
    """The plain encoder's result on _tiny_blocks() at TINY_CAPS (made once
    per process; the callers only read it)."""
    return _plain(_tiny_blocks(), TINY_PARAMS, TINY_CAPS)


def _xla(blocks, params, caps, chunk_steps=8192):
    params, caps = jax_twin(params), jax_twin(caps)
    text, tlen = jcodec.pack_blocks(blocks, params, caps)
    return jcodec.encode_blocks_chunked(jnp.asarray(text), jnp.asarray(tlen),
                                        params, caps, chunk_steps=chunk_steps)


def _assert_same(ours, ref, lanes):
    """Lanes ``lanes`` of the port's result against x3tpu's result."""
    words, lens, counts, sizes, of = ours
    rwords, rlens, rcounts, rsizes, rof = ref
    np.testing.assert_array_equal(words.numpy()[lanes],
                                  np.asarray(rwords).astype(np.int64))
    np.testing.assert_array_equal(lens.numpy()[lanes], np.asarray(rlens))
    np.testing.assert_array_equal(counts.numpy()[lanes], np.asarray(rcounts))
    np.testing.assert_allclose(sizes.numpy()[lanes], np.asarray(rsizes),
                               rtol=1e-5, atol=1e-3)
    for name in of._fields:
        np.testing.assert_array_equal(getattr(of, name).numpy()[lanes],
                                      np.asarray(getattr(rof, name)),
                                      err_msg=name)


@functools.lru_cache(maxsize=None)
def plain_t4():
    """One plain batch under the t4_w1 paramset (== SMALL_PARAMS): the XLA
    batch in lanes 0-5, then the golden inputs it does not hold already
    (lanes are independent, so sharing the batch changes no lane's
    result).  Returns (blocks, the lane of each golden input, result);
    made once per process, the callers only read it."""
    blocks = _xla_inputs()
    lane_of = {}
    for name in GOLDEN_NAMES:
        data = (GOLDEN / f"{name}.bin").read_bytes()
        if data not in blocks:
            blocks.append(data)
        lane_of[name] = blocks.index(data)
    return blocks, lane_of, _plain(blocks, SMALL_PARAMS, SMALL_CAPS)


@pytest.fixture(scope="module")
def t4_batch():
    return plain_t4()


def test_plain_matches_xla(t4_batch):
    blocks, _, ours = t4_batch
    ref = _xla(_xla_inputs(), SMALL_PARAMS, SMALL_CAPS)
    _assert_same(ours, ref, slice(0, 6))
    streams = codec.streams_from_words(ours[0], ours[1], 6)
    for i, b in enumerate(_xla_inputs()):
        assert streams[i] == spec.encode(b, jax_twin(SMALL_PARAMS)), f"block {i}"


def test_plain_matches_xla_tiny_caps():
    """Capacities where the dictionary, both context families, the pair map
    and the output buffer overflow: the same sticky flags and the same
    (dropped-write) streams as x3tpu's engine, and the lanes beside the
    one whose words are dropped keep theirs."""
    ours = plain_tiny()
    ref = _xla(_tiny_blocks(), TINY_PARAMS, TINY_CAPS, chunk_steps=TINY_CHUNK)
    _assert_same(ours, ref, slice(None))
    for name in OVERFLOW_FLAGS:
        assert getattr(ours[4], name).any(), name
    out = ours[4].out.numpy()
    assert out.tolist() == [i == 3 for i in range(len(out))]


@pytest.fixture(scope="module")
def golden_streams(t4_batch):
    """pname -> {input name: the plain encoder's stream}, one batch per
    paramset (the t4_w1 inputs ride in the shared t4 batch)."""
    runs = {}

    def get(pname):
        if pname not in runs:
            if pname == "t4_w1":
                blocks, lane_of, out = t4_batch
            else:
                names = [n for n, p in golden_cases() if p == pname]
                blocks = [(GOLDEN / f"{n}.bin").read_bytes() for n in names]
                lane_of = {n: i for i, n in enumerate(names)}
                out = _plain(blocks, X3Params(**PARAMSETS[pname]), SMALL_CAPS)
            assert not out[4].any_flag().any()
            streams = codec.streams_from_words(out[0], out[1], len(blocks))
            runs[pname] = {n: streams[i] for n, i in lane_of.items()}
        return runs[pname]

    return get


@pytest.mark.parametrize("name,pname", golden_cases())
def test_golden_stream(name, pname, golden_streams):
    """Each golden fixture byte-identical, batched by paramset."""
    want = (GOLDEN / f"{name}.{pname}.x3").read_bytes()
    assert golden_streams(pname)[name] == want


def test_counts_match_spec(t4_batch):
    """Event counters equal the spec oracle's (x3.c:42 events[])."""
    blocks, lane_of, out = t4_batch
    for i in (2, 5, lane_of["lowent"]):
        spec.encode(blocks[i], jax_twin(SMALL_PARAMS))
        np.testing.assert_array_equal(out[2].numpy()[i],
                                      spec.encode.last_stats.events,
                                      err_msg=f"block {i}")


def test_one_lane_second_veto_factor():
    """One lane at magic factor 2: the sweep probes every offset of a
    one-row window, whose slices are contiguous at odd offsets; the stream
    is x3tpu's."""
    data = (GOLDEN / "text_small.bin").read_bytes()[:300]
    params = X3Params(max_match_count=4, window=256, magic_factor2=2)
    out = _plain([data], params, CodecCaps(dict_cap=256, pair_cap=1024,
                                           ctx_items_cap=64, block_bytes=1024))
    assert codec.streams_from_words(out[0], out[1], 1)[0] == host.encode(
        data, jax_twin(params))


def test_pair_overflow_exact_boundary():
    """The pair flag fires for the first id that cannot have its own row,
    and not before: pair_cap == the host codec's pair count is the exact
    overflow-free minimum (tests/test_codec_jax.py, here with no JAX)."""
    data = (GOLDEN / "text_small.bin").read_bytes()[:300]
    npairs = host.measure_state(data, jax_twin(SMALL_PARAMS))["pairs"]
    assert npairs > 8
    base = dict(dict_cap=1 << 10, ctx_items_cap=64, block_bytes=1 << 13)
    ok = _plain([data], SMALL_PARAMS, CodecCaps(pair_cap=npairs, **base))
    assert not ok[4].any_flag().any()
    assert codec.streams_from_words(ok[0], ok[1], 1)[0] == host.encode(
        data, jax_twin(SMALL_PARAMS))
    bad = _plain([data], SMALL_PARAMS, CodecCaps(pair_cap=npairs - 1, **base))
    assert bad[4].pairs.all()
