"""The port's lane groups (``x3tpu_torch.parallel.mesh``) on the CPU,
mirroring tests/test_parallel.py's mesh tests: the wave width against
x3tpu's over its virtual CPU devices; ``compress`` over 2- and 4-entry CPU
meshes, unseeded and seeded, with pad lanes, byte for byte x3tpu's
container of ``x3tpu.host.encode``'s payloads and the one-device output,
and back through ``decompress(mesh=)``; a group split into launches by a
memory budget; an overflow in one group retried for the whole wave; the
journal's fingerprint over the mesh size; the memory share of entries on
one card; and the refusals of ``make_mesh``."""

import functools
import types

import pytest
import torch

from x3tpu import host as jhost
from x3tpu import spec
from x3tpu.parallel import blocks as jblk
from x3tpu.parallel import mesh as jmesh
from x3tpu.parallel import runtime as jruntime
from x3tpu_torch import codec
from x3tpu_torch.config import CodecCaps, X3Params
from x3tpu_torch.parallel import mesh as meshmod
from x3tpu_torch.parallel import runtime
from x3tpu_torch.vm import driver

from conftest import GOLDEN
from test_torch_codec import jax_twin
from test_torch_codec import one_thread  # noqa: F401  (autouse)
from test_torch_journal import _count_waves, _cut_after_first_wave

PARAMS = X3Params(max_match_count=4, window=256)
CAPS = CodecCaps(dict_cap=256, pair_cap=1024, ctx_items_cap=64,
                 block_bytes=96)
BLOCK = 96
# five blocks: no mesh of 2 or 4 entries divides them, so waves pad
DATA = (GOLDEN / "text_small.bin").read_bytes()[: 5 * BLOCK - 29]
CPU = torch.device("cpu")


def cpu_mesh(n):
    return meshmod.make_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_wave_lanes_matches_x3tpu(nd):
    """The lanes of a wave: a multiple of the mesh size that covers the
    blocks, bounded by lanes_per_device a device, as x3tpu's over its
    virtual CPU devices (no mesh: one device)."""
    ours, theirs = cpu_mesh(nd), jmesh.make_mesh(nd)
    for nblocks in (0, 1, 3, 5, 8, 9, 31, 64, 100):
        for lpd in (0, 1, 2, 3, 32):
            want = jruntime._wave_lanes(nblocks, theirs, lpd)
            assert runtime._wave_lanes(nblocks, ours, lpd) == want
            if nd == 1:
                assert runtime._wave_lanes(nblocks, None, lpd) == want


def test_empty_stream_is_the_encoders():
    """The pad lanes' stream is an empty block's: the reference's and the
    port's encoder's."""
    assert runtime.EMPTY_STREAM == spec.encode(b"")
    text, tlen = codec.pack_blocks([b""], PARAMS, CAPS)
    enc = codec.encode_blocks_chunked(text, tlen, PARAMS, CAPS)
    assert codec.streams_from_words(enc[0], enc[1], 1) == [
        runtime.EMPTY_STREAM]


@functools.lru_cache(maxsize=None)
def one_device(dict_seed):
    """compress on one CPU device, no mesh."""
    return runtime.compress(DATA, PARAMS, block_bytes=BLOCK, caps=CAPS,
                            dict_seed=dict_seed, seed_k=16, device="cpu")


def x3tpu_container(dict_seed):
    """x3tpu's container of x3tpu.host.encode's payloads (seeded from
    x3tpu's trainer on compress's strided sample)."""
    parts = jblk.split_blocks(DATA, BLOCK)
    seed_bytes, seeds = [], None
    if dict_seed:
        per = 64 * 1024 // len(parts)
        strs, lens = jhost.train_seeds(b"".join(p[:per] for p in parts),
                                       jax_twin(PARAMS), 16, ranked=True)
        seed_bytes = [bytes(strs[i, : lens[i]]) for i in range(len(lens))]
        seeds = runtime.seeds_to_arrays(seed_bytes)
    payloads = [jhost.encode(p, jax_twin(PARAMS), seeds=seeds)
                for p in parts]
    return jblk.pack_container(payloads, [len(p) for p in parts], BLOCK,
                               seeds=seed_bytes)


@pytest.mark.parametrize("dict_seed", [False, True], ids=["plain", "seeded"])
@pytest.mark.parametrize("nd,lpd", [(2, 2), (4, 1)])
def test_compress_over_cpu_mesh(nd, lpd, dict_seed):
    """Five blocks over 2 entries at 2 lanes a device (a wave of 4, then
    1 block padded to 2) and over 4 at 1 (4, then 1 padded to 4): x3tpu's
    container and the one-device output, byte for byte; decompress over
    the same mesh pads its last wave with the empty stream and gives the
    data back."""
    mesh = cpu_mesh(nd)
    out = runtime.compress(DATA, PARAMS, block_bytes=BLOCK, caps=CAPS,
                           dict_seed=dict_seed, seed_k=16,
                           lanes_per_device=lpd, device="cpu", mesh=mesh)
    assert bool(jblk.unpack_container(out)[3]) == dict_seed
    assert out == x3tpu_container(dict_seed)
    assert out == one_device(dict_seed)
    assert runtime.decompress(out, lanes_per_device=lpd, device="cpu",
                              mesh=mesh) == DATA


def _calls(monkeypatch, name):
    """The lanes of each call of codec.``name`` (one a CPU launch)."""
    calls = []
    fn = getattr(codec, name)

    def counted(*args, **kwargs):
        calls.append(len(args[1]))
        return fn(*args, **kwargs)

    monkeypatch.setattr(codec, name, counted)
    return calls


def test_budget_splits_each_group(monkeypatch):
    """A budget of one lane a launch over 2 entries of 2 lanes: two
    launches a group each way, x3tpu.host's streams, and the blocks
    back."""
    parts = [DATA[i : i + BLOCK] for i in range(0, 4 * BLOCK, BLOCK)]
    mesh = cpu_mesh(2)
    enc = _calls(monkeypatch, "encode_blocks_chunked")
    res = runtime.encode_wave(
        parts, PARAMS, CAPS, device="cpu", mesh=mesh,
        mem_budget=driver.encoder_lane_bytes(PARAMS, CAPS))
    assert enc == [1, 1, 1, 1]
    assert res.payloads == [jhost.encode(p, jax_twin(PARAMS)) for p in parts]
    dec = _calls(monkeypatch, "decode_blocks_chunked")
    iw = max(len(p) + 3 for p in res.payloads) // 4
    back = runtime.decode_wave(
        res.payloads, [len(p) for p in parts], CAPS, device="cpu", mesh=mesh,
        mem_budget=driver.decoder_lane_bytes(CAPS, iw))
    assert dec == [1, 1, 1, 1]
    assert back.payloads == parts


def test_overflow_in_one_group_retries_the_wave(monkeypatch):
    """Random bytes outgrow the output buffer on lane 3 alone (the second
    group of a 2-entry mesh): the whole wave is run again with more
    headroom, and every stream is x3tpu.host's."""
    import numpy as np

    rnd = np.random.default_rng(9).integers(0, 256, 90, np.uint8).tobytes()
    parts = [b"x" * 90, b"hello world " * 8, b"abc" * 30, rnd]
    caps = CodecCaps(dict_cap=256, pair_cap=1024, ctx_items_cap=64,
                     block_bytes=BLOCK, out_words_factor=1)
    assert len(jhost.encode(rnd, jax_twin(PARAMS))) > 4 * caps.out_words
    lanes = []
    run = meshmod.encode_sharded

    def recording(*args):
        out = run(*args)
        lanes.append(out[4].any_flag().nonzero().flatten().tolist())
        return out

    monkeypatch.setattr(meshmod, "encode_sharded", recording)
    res = runtime.encode_wave(parts, PARAMS, caps, device="cpu",
                              mesh=cpu_mesh(2))
    assert lanes == [[3], []]
    assert res.payloads == [jhost.encode(p, jax_twin(PARAMS)) for p in parts]


def test_journal_mesh_size_mismatch(tmp_path, monkeypatch):
    """A journal written over 2 entries (waves of 2 blocks) is not spliced
    into a run over 4 (waves of 4): the wave width, mesh size times
    lanes_per_device, is in the fingerprint, so every wave is encoded
    again and the container is the one-device one."""
    jpath = str(tmp_path / "job.journal")
    kw = dict(data=DATA, params=PARAMS, block_bytes=BLOCK, caps=CAPS,
              lanes_per_device=1, device="cpu")
    _cut_after_first_wave(monkeypatch, journal_path=jpath, mesh=cpu_mesh(2),
                          **kw)
    waves = _count_waves(monkeypatch)
    resumed = runtime.compress(journal_path=jpath, mesh=cpu_mesh(4), **kw)
    assert waves["n"] == 2   # both four-lane waves, none from the journal
    assert resumed == one_device(False)


def test_entries_on_one_card_share_its_memory(monkeypatch):
    """Two entries on one card get half the card's budget each: 56 lanes
    of caps_for_block(1 MiB) a launch where one entry gets 113 (an 80 GB
    card); a wave of 120 lanes is cut into launches of 56, 4 in each
    group, every launch made before any result is read."""
    props = types.SimpleNamespace(total_memory=85_045_116_928)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    caps = runtime.caps_for_block(1 << 20)
    lane = driver.encoder_lane_bytes(X3Params(), caps)
    card = torch.device("cuda", 0)
    assert meshmod.launch_lanes(lane, caps, card) == 113
    assert meshmod.launch_lanes(lane, caps, card, sharing=2) == 56
    assert meshmod.launch_lanes(lane, caps, card, sharing=2) == (
        meshmod.launch_lanes(lane, caps, card, int(
            meshmod.MEM_SHARE * props.total_memory) // 2))
    made, results = [], []

    def launch(dev, stream, lo, hi):
        made.append((dev, lo, hi))
        zeros = torch.zeros(hi - lo, dtype=torch.bool)
        return (zeros,) * 4 + (codec.Overflow(*[zeros] * 5),)

    def on_host(run):
        results.append(len(made))
        return run

    monkeypatch.setattr(meshmod, "_on_host", on_host)
    two = meshmod.Mesh((card, card), (None, None))
    meshmod._sharded(120, two, lane, caps, None, launch)
    assert made == [(card, 0, 56), (card, 56, 60), (card, 60, 116),
                    (card, 116, 120)]
    assert results == [4, 4, 4, 4]
    made.clear()
    meshmod._sharded(120, meshmod.single(card), lane, caps, None, launch)
    assert made == [(card, 0, 113), (card, 113, 120)]


def test_make_mesh_refuses_what_is_not_there():
    """More devices than exist, a CUDA device that does not exist, an
    empty or mixed mesh, and a device= beside a mesh of another type all
    raise; nothing runs on fewer devices or on the CPU."""
    count = torch.cuda.device_count()
    with pytest.raises((RuntimeError, ValueError), match="device"):
        meshmod.make_mesh(count + 1)
    with pytest.raises((RuntimeError, ValueError), match="cuda"):
        meshmod.make_mesh(devices=[f"cuda:{count}"])
    with pytest.raises(ValueError, match="3 devices asked for, 2"):
        meshmod.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        meshmod.make_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="a mesh needs a device"):
        meshmod.make_mesh(devices=[])
    card = meshmod.Mesh((torch.device("cuda", 0),), (None,))
    with pytest.raises(ValueError, match="beside a mesh"):
        runtime.compress(b"abc", device="cpu", mesh=card)
    two = cpu_mesh(2)
    assert two.devices == (CPU, CPU) and two.streams == (None, None)
