"""Driver of the CUDA kernels K1 (encoder) and K2 (decoder), the port of
``x3tpu.vm.driver``: builds ``csrc/x3_encoder.cu`` and ``csrc/x3_decoder.cu``
with nvcc at first use (one nvcc per source, run side by side), loads them
with ctypes, checks the inputs, allocates state and outputs, and launches
one kernel per call.

:func:`encode_blocks_cuda` has the contract of
``x3tpu_torch.codec.encode_blocks_chunked``: (words [L, out_words] u32 in
int64, byte_lens, counts, sizes, Overflow); :func:`decode_blocks_cuda` that
of ``codec.decode_blocks_chunked``: (out u8 [L, block_bytes], out_lens,
counts, sizes, Overflow).  Each is two steps: :func:`launch_encode` /
:func:`launch_decode` launch on a stream and return at once (a
:class:`Launch`), and :meth:`Launch.result` waits, checks the flags and
returns the tuple; the mesh (``x3tpu_torch.parallel.mesh``) launches every
lane group before it reads any result.  Nothing falls back: a failed
build or launch raises, and so does a tensor that is not on a CUDA device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from x3tpu_torch.config import MAX_MATCH_LEN, CodecCaps, X3Params
from x3tpu_torch import codec

# launches of each kernel since the last reset (the main-path check)
LAUNCHES = {"encoder": 0, "decoder": 0}
# kernel -> its source; each builds into a library of its own
SOURCES = {"encoder": "x3_encoder.cu", "decoder": "x3_decoder.cu"}

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "x3tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# per-lane flag bits written by the kernel (x3_core.cuh OF_*)
OF_DICT, OF_CTX0, OF_CTX1, OF_PAIRS, OF_OUT, OF_STEPS = 1, 2, 4, 8, 16, 32
OF_CORRUPT = 64

# shared memory of one CTA (x3_core.cuh): what a block may use on the card,
# and the most K1's static part takes; the plan's planes get the rest
SMEM_BLOCK_MAX = 232448
SMEM_STATIC = 16384
# the largest dictionary whose planes K1 keeps in shared memory: above it
# every plane stays global, where L1 holds the hot ones (with planes of
# 189-206 KB in shared memory, L1 keeps about 28 KB of the SM's 256 KB)
SMEM_DICT_MAX = 1024
# the planes K1 may keep in shared memory, hottest first, then the index
# model's tree (x3_core.cuh PL_*)
SMEM_PLANES = ("text", "strs", "lens", "rank_of", "ix", "f1_hub_tags",
               "f1_hub_freqs", "f1_hub_pair", "f0_hub_tags", "f0_hub_freqs",
               "f1_n", "f1_promo", "ix_tree")


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    """Where K1 keeps a lane's planes: ``offsets`` maps each plane in the
    CTA's dynamic shared memory to its byte offset there; the others stay
    in the lane's global scratch."""

    offsets: Dict[str, int]
    nbytes: int

    @property
    def mask(self) -> int:
        """Bit k: plane k of SMEM_PLANES is in shared memory."""
        return sum(1 << k for k, name in enumerate(SMEM_PLANES)
                   if name in self.offsets)


def smem_plan(params: X3Params, caps: CodecCaps) -> SmemPlan:
    """The planes of a launch that go to shared memory: each in order, at a
    16-byte boundary, while it fits in what a block may have beside K1's
    static part (x3_core.cuh place_smem packs the same planes the same
    way).  At ``caps_for_block(16 KiB)`` every plane fits (103 504 bytes).
    Above SMEM_DICT_MAX entries the plan is empty: all-global measured
    2-4 % faster at dict 2048-8192 and 13-34 % faster at dict 6144-24576
    (32 KiB to 1 MiB blocks, ``tools/kernel_ab.py --plan``), and equal at
    dict 1024."""
    d = caps.dict_cap
    if d > SMEM_DICT_MAX:
        return SmemPlan({}, 0)
    sizes = dict.fromkeys(SMEM_PLANES, 4 * d)  # int32 planes of D entries
    sizes["text"] = codec.text_bytes(params, caps)
    sizes["strs"] = d * MAX_MATCH_LEN
    sizes["ix_tree"] = 4 * ix_tree_words(caps)
    at, offsets = 0, {}
    for name in SMEM_PLANES:
        size = -(-sizes[name] // 16) * 16
        if at + size <= SMEM_BLOCK_MAX - SMEM_STATIC:
            offsets[name] = at
            at += size
    return SmemPlan(offsets, at)

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None
BUILD_LOG = ""   # nvcc's output of the builds this process made (ptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("x3tpu_torch: nvcc not found (needed to build the "
                       "CUDA kernels)")


def library_path(kernel: str) -> pathlib.Path:
    """A kernel's library for the current sources and flags (the hash
    covers every csrc/*.cu and *.cuh: the kernels share headers)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libx3{kernel}_{h.hexdigest()[:16]}.so"


def build() -> Dict[str, pathlib.Path]:
    """Compile every kernel whose library for this source hash is missing,
    one nvcc per source, all started together.  Libraries are renamed into
    place, so concurrent builds are safe."""
    global BUILD_LOG
    libs = {k: library_path(k) for k in SOURCES}
    todo = {k: lib for k, lib in libs.items() if not lib.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for k, lib in todo.items():
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[k])]
            procs[k] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = [], []
        for k, (tmp, proc) in procs.items():
            out = proc.communicate()[0]
            logs.append(f"[{SOURCES[k]}]\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc {SOURCES[k]} failed "
                              f"({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[k])
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def _bind_encoder(lib: ctypes.CDLL, phases: bool = False) -> None:
    """argtypes of K1's entry points (``phases``: the library built with
    -DX3_PHASES, whose x3_encode takes one more pointer)."""
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.x3_scratch_words.restype = ll
    lib.x3_scratch_words.argtypes = [i] * 6
    lib.x3_dict_layout.restype = None
    lib.x3_dict_layout.argtypes = [i] * 6 + [p]
    lib.x3_encode.restype = i
    lib.x3_fam_layout.restype = None
    lib.x3_fam_layout.argtypes = [i] * 7 + [p]
    lib.x3_encode.argtypes = ([p, p, i, ll] + [i] * 12 + [ctypes.c_uint]
                              + [i] * 4 + [p] * (8 if phases else 7))
    lib.x3_encoder_info.restype = i
    lib.x3_encoder_info.argtypes = [i, p]
    lib.x3_hash_slots.restype = ll
    lib.x3_hash_slots.argtypes = [i]
    lib.x3_ix_tree_words.restype = ll
    lib.x3_ix_tree_words.argtypes = [i]


def _bind_decoder(lib: ctypes.CDLL, phases: bool = False) -> None:
    """argtypes of K2's entry points (``phases``: the library built with
    -DX3_DEC_PHASES, whose x3_decode takes one more pointer)."""
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.x3_decode.restype = i
    lib.x3_decode.argtypes = [p, p] + [i] * 13 + [p] * (8 if phases else 7)
    lib.x3_decoder_info.restype = i
    lib.x3_decoder_info.argtypes = [p]


def _load() -> Dict[str, ctypes.CDLL]:
    global _libs
    with _lock:
        if _libs is None:
            libs = {k: ctypes.CDLL(str(path)) for k, path in build().items()}
            _bind_encoder(libs["encoder"])
            _bind_decoder(libs["decoder"])
            _libs = libs
        return _libs


def _info(kernel: str, warm: bool) -> Dict[str, int]:
    out = (ctypes.c_int * 3)()
    lib = _load()[kernel]
    rc = (lib.x3_encoder_info(int(warm), out) if kernel == "encoder"
          else lib.x3_decoder_info(out))
    if rc != 0:
        raise RuntimeError(f"x3_{kernel}_info failed: cudaError {rc}")
    return {"registers": out[0], "static_smem": out[1], "local_bytes": out[2]}


def encoder_info(warm: bool = False) -> Dict[str, int]:
    """K1 as the loaded module has it, its unwarmed instantiation or its
    warm one: registers a thread, static shared memory, local (spill) bytes
    a thread."""
    return _info("encoder", warm)


def decoder_info() -> Dict[str, int]:
    """K2 as the loaded module has it: registers a thread, static shared
    memory, local (spill) bytes a thread."""
    return _info("decoder", False)


def _fam_layout(h: int, s: int, items: int, small_cap: int, promo_rows: int,
                with_pair: bool, at: int) -> Dict[str, int]:
    """One context family's planes from word ``at`` on (x3_core.cuh
    make_fam); ``"end"`` is the word after them."""
    cs = min(small_cap, items)
    m = promo_rows if promo_rows else max(s // 8, 16)
    sizes = (("hub_tags", h), ("hub_freqs", h),
             ("hub_pair", h if with_pair else 0), ("tags", s * cs),
             ("freqs", s * cs), ("pair", s * cs if with_pair else 0),
             ("n", s), ("promo", s), ("big_tags", m * items),
             ("big_freqs", m * items),
             ("big_pair", m * items if with_pair else 0), ("big_n", m))
    out = {}
    for name, size in sizes:
        out[name] = at
        at += size
    out["end"] = at
    return out


def layout(caps: CodecCaps) -> Dict[str, object]:
    """A lane's scratch layout in int32 words, the copy of x3_core.cuh
    make_layout that needs no kernel library, for the launch split's lane
    bytes (the CPU tests hold it against the host build's, and every
    launch against the kernels', :func:`kernel_layout`): the dictionary
    planes, ``"f0"`` and ``"f1"`` (each family's planes,
    :func:`_fam_layout`) and ``"words"``, the lane's total."""
    d, at, out = caps.dict_cap, 0, {}
    for name, size in (("strs", d * MAX_MATCH_LEN // 4), ("lens", d),
                       ("rank_of", d), ("tag_of", d), ("ix", d)):
        out[name] = at
        at += size
    out["f0"] = _fam_layout(d, caps.pair_cap, caps.ctx0_items_cap,
                            caps.ctx_small_cap, caps.ctx_promo_rows, False, at)
    out["f1"] = _fam_layout(d, d, caps.ctx_items_cap, caps.ctx_small_cap,
                            caps.ctx_promo_rows, True, out["f0"]["end"])
    out["words"] = out["f1"]["end"]
    return out


def scratch_words(caps: CodecCaps) -> int:
    """int32 words of dictionary and context state one lane needs (the
    same layout for both kernels), from :func:`layout`."""
    return layout(caps)["words"]


def hash_slots(caps: CodecCaps) -> int:
    """int32 words of K1's hash index of its dictionary, which a lane's
    scratch holds after :func:`scratch_words` (x3_core.cuh hash_slots; K2's
    scratch has none): the least power of two of at least twice
    ``dict_cap``."""
    return 1 << (2 * caps.dict_cap - 1).bit_length()


def ix_tree_words(caps: CodecCaps) -> int:
    """int32 words of K1's index model as a Fenwick tree, which a lane's
    scratch holds after :func:`hash_slots` (x3_core.cuh ix_tree_words; K2's
    scratch has none): a node a rank position, and the unused node 0."""
    return caps.dict_cap + 1


# per-lane bytes of a launch's small outputs: lengths, counts, sizes, flags
_LANE_SMALL = 4 + 20 + 20 + 4


def encoder_lane_bytes(params: X3Params, caps: CodecCaps) -> int:
    """Device bytes one lane of a K1 launch takes: its zeroed scratch (the
    hash index's and the index model tree's planes included), its text
    row, its output words (int32 from the kernel, then the int64 copy and
    the masked one the wrapper returns) and its small outputs."""
    return (4 * (scratch_words(caps) + hash_slots(caps) + ix_tree_words(caps))
            + codec.text_bytes(params, caps) + 20 * caps.out_words
            + _LANE_SMALL + 4)


def decoder_lane_bytes(caps: CodecCaps, iw: int) -> int:
    """Device bytes one lane of a K2 launch of ``iw`` stream words takes:
    its zeroed scratch, its stream, its output row and its small
    outputs."""
    return (4 * scratch_words(caps) + 4 * iw + caps.block_bytes
            + _LANE_SMALL + 4)


# the dictionary planes a seeded start writes, in x3_dict_layout's order
DICT_PLANES = ("strs", "lens", "rank_of", "tag_of", "ix")


def dict_layout(caps: CodecCaps, lib: Optional[ctypes.CDLL] = None,
                fn: str = "x3_dict_layout") -> Dict[str, int]:
    """The dictionary planes' offsets in a lane's scratch, in int32 words:
    from :func:`layout`, or from ``lib``'s ``fn`` where given (the kernels'
    layout query; the CPU tests pass the host build's
    ``x3h_dict_layout``)."""
    if lib is None:
        lay = layout(caps)
        return {k: lay[k] for k in DICT_PLANES}
    out = (ctypes.c_longlong * len(DICT_PLANES))()
    getattr(lib, fn)(
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
        caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows, out)
    return dict(zip(DICT_PLANES, out))


def seed_scratch(scratch: torch.Tensor, offsets: Dict[str, int], seeds,
                 cumulative: bool) -> None:
    """Write the K dictionary ``seeds`` (strs u8 [K, 32], lens i32 [K])
    into every lane of ``scratch`` (i32 [L, words], zeroed) at ``offsets``
    (:func:`dict_layout`), as x3_core.cuh seed_dict does: the strings and
    lengths at tags 0..K-1, rank_of = tag_of = 0..K-1, and the index model
    over the first K entries, freq 1 a seed for K1 or, ``cumulative``,
    their inclusive sum 1..K for K2 (x3tpu/vm/driver.py _seed_dict_arrays).
    One pass serves both kernels, which share the layout."""
    k = int(seeds[0].shape[0])
    dev = scratch.device
    strs = torch.as_tensor(seeds[0], dtype=torch.uint8).contiguous()
    words = to_device(strs.view(torch.int32).reshape(-1), dev)  # K x 8 words
    ii = torch.arange(k, dtype=torch.int32, device=dev)
    planes = {
        "strs": words,
        "lens": to_device(torch.as_tensor(seeds[1], dtype=torch.int32), dev),
        "rank_of": ii, "tag_of": ii,
        "ix": ii + 1 if cumulative else torch.ones_like(ii),
    }
    for name, vals in planes.items():
        at = offsets[name]
        scratch[:, at : at + vals.numel()] = vals


# a context family's planes, in x3_fam_layout's order (x3_core.cuh
# fam_offsets; _fam_layout's names)
FAM_PLANES = ("hub_tags", "hub_freqs", "hub_pair", "tags", "freqs", "pair",
              "n", "promo", "big_tags", "big_freqs", "big_pair", "big_n")


def fam_layout(caps: CodecCaps, lib: Optional[ctypes.CDLL] = None,
               fn: str = "x3_fam_layout") -> Dict[str, Dict[str, int]]:
    """Both context families' plane offsets in a lane's scratch, in int32
    words (``"f0"``, ``"f1"``, each FAM_PLANES to its offset): from
    :func:`layout`, or from ``lib``'s ``fn`` where given (K1's layout
    query; the CPU tests pass the host build's ``x3h_fam_layout``)."""
    if lib is None:
        lay = layout(caps)
        return {f: {k: lay[f][k] for k in FAM_PLANES} for f in ("f0", "f1")}
    out = {}
    for fam in (0, 1):
        buf = (ctypes.c_longlong * len(FAM_PLANES))()
        getattr(lib, fn)(
            caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
            caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows,
            fam, buf)
        out[f"f{fam}"] = dict(zip(FAM_PLANES, buf))
    return out


def warm_scratch(scratch: torch.Tensor, offsets: Dict[str, Dict[str, int]],
                 warm, caps: CodecCaps) -> tuple:
    """Write the warm state ``warm`` (``x3tpu_torch.warm.WarmArrays``) into
    every lane of ``scratch`` (i32 [L, words], zeroed, the seeds it needs
    written in) at the families' ``offsets`` (:func:`fam_layout`), as the
    plain codec starts from it (``codec._init_shared``): both hubs' tags
    and freqs, the ctx1 hub's pair ids, and the small-pool rows' tags,
    freqs, pair ids and item counts; freqs raw, as both kernels' rows keep
    them, and no row promoted.  Raises ValueError where ``caps`` cannot
    hold the state (``warm.check_fits``, in ``codec.warm_tables``).
    Returns the counts the kernels start from: (pair_n, ctx0 hub items,
    ctx1 hub items)."""
    w = codec.warm_tables(warm, caps)
    at, vals = [], []   # word offsets and values, one index pass for all
    for fam, items, hub, pool in (
            ("f0", caps.ctx0_items_cap, w["h0"], w["c0"]),
            ("f1", caps.ctx_items_cap, w["h1"], w["c1"])):
        off = offsets[fam]
        cs = min(caps.ctx_small_cap, items)   # x3_core.cuh make_fam CS
        hub_slots = np.arange(hub["n"])
        rows = pool["rows"]
        slots = (rows[:, None] * cs + np.arange(pool["t"].shape[1])).ravel()
        for plane, base, key, src in (
                ("hub_tags", hub_slots, "t", hub),
                ("hub_freqs", hub_slots, "f", hub),
                ("hub_pair", hub_slots, "p", hub),
                ("tags", slots, "t", pool), ("freqs", slots, "f", pool),
                ("pair", slots, "p", pool), ("n", rows, "n", pool)):
            if key in src:
                at.append(off[plane] + base)
                vals.append(np.asarray(src[key], np.int32).ravel())
    dev = scratch.device
    scratch[:, to_device(np.concatenate(at), dev)] = to_device(
        np.concatenate(vals), dev)
    return w["pair_n"], w["h0"]["n"], w["h1"]["n"]


def kernel_layout(caps: CodecCaps, lib: Optional[ctypes.CDLL] = None):
    """A lane's scratch words and the dictionary planes' offsets as the
    kernel library ``lib`` (default: the main path's K1) has them
    (x3_scratch_words, x3_dict_layout): every launch's scratch is sized and
    seeded from these.  Raises if the Python copy (:func:`layout`), by
    which the launch split counts a lane's bytes, differs."""
    return _kernel_layout(lib or _load()["encoder"], caps)


@functools.lru_cache(maxsize=None)
def _kernel_layout(lib: ctypes.CDLL, caps: CodecCaps):
    words = lib.x3_scratch_words(
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
        caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows)
    offsets = dict_layout(caps, lib)
    if words != scratch_words(caps) or offsets != dict_layout(caps):
        raise RuntimeError(
            f"the kernels' scratch layout ({words} words, {offsets}) is not "
            f"driver.layout's ({scratch_words(caps)}, {dict_layout(caps)}) "
            f"at {caps}")
    return words, offsets


@functools.lru_cache(maxsize=None)
def _kernel_k1_words(lib: ctypes.CDLL, caps: CodecCaps) -> int:
    """K1's words a lane past the layout's: its hash index
    (x3_hash_slots) and its index model tree (x3_ix_tree_words), which
    must be :func:`hash_slots`' and :func:`ix_tree_words`'."""
    slots = lib.x3_hash_slots(caps.dict_cap)
    tree = lib.x3_ix_tree_words(caps.dict_cap)
    if (slots, tree) != (hash_slots(caps), ix_tree_words(caps)):
        raise RuntimeError(
            f"K1's hash index and tree ({slots}, {tree} words) are not "
            f"driver.hash_slots' and ix_tree_words' ({hash_slots(caps)}, "
            f"{ix_tree_words(caps)}) at {caps}")
    return slots + tree


@functools.lru_cache(maxsize=None)
def _kernel_fam_layout(lib: ctypes.CDLL, caps: CodecCaps):
    offsets = fam_layout(caps, lib)
    if offsets != fam_layout(caps):
        raise RuntimeError(
            f"the kernels' context family layout ({offsets}) is not "
            f"driver.layout's ({fam_layout(caps)}) at {caps}")
    return offsets


def _seeded_scratch(lanes: int, caps: CodecCaps, dev, seeds,
                    cumulative: bool, lib: Optional[ctypes.CDLL] = None,
                    warm=None, extra: int = 0):
    """A wave's zeroed scratch with the seeds and the warm state written
    in, K and the warm counts (:func:`warm_scratch`; zeros without
    ``warm``); the layout is the kernel library ``lib``'s
    (:func:`kernel_layout`, and for a warm start K1's family layout
    query, which must equal :func:`layout`), each lane ``extra`` words
    longer (K1's hash index and index model tree)."""
    k = codec.check_seeds(seeds, caps, warm)
    lib = lib or _load()["encoder"]
    words, offsets = kernel_layout(caps, lib)
    scratch = torch.zeros((lanes, words + extra), dtype=torch.int32,
                          device=dev)
    if k:
        seed_scratch(scratch, offsets, seeds, cumulative)
    counts = (0, 0, 0)
    if warm is not None:
        counts = warm_scratch(scratch, _kernel_fam_layout(lib, caps), warm,
                              caps)
    return scratch, k, counts


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def to_device(a, dev: torch.device) -> torch.Tensor:
    """``a`` (an array or a CPU tensor) on ``dev``.  For a CUDA device the
    copy goes through pinned memory and is queued on the current stream
    without waiting for it: a copy from pageable memory would wait for the
    stream's earlier work, so a group's second launch could not be queued
    before its first had run."""
    t = torch.as_tensor(a)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


@dataclasses.dataclass
class Launch:
    """A kernel launch in flight on ``stream``: its outputs, still being
    written, and the check that reads its flags.  Nothing waits for the
    card until :meth:`result`, so launches on several streams or devices
    run side by side."""

    outs: tuple
    stream: torch.cuda.Stream
    finish: Callable

    def result(self):
        """Wait for the launch, raise as its flags say, and return the
        plain version's tuple (on the launch's device and stream)."""
        with torch.cuda.device(self.stream.device), \
                torch.cuda.stream(self.stream):
            return self.finish(*self.outs)


def encode_blocks_cuda(text: torch.Tensor, tlen: torch.Tensor,
                       params: X3Params, caps: CodecCaps, seeds=None,
                       warm=None):
    """Encode L blocks with kernel K1: ``text`` u8 [L, TB] from
    ``codec.pack_blocks`` and ``tlen`` i32 [L], both on one CUDA device,
    every lane from the dictionary ``seeds`` (strs u8 [K, 32], lens i32
    [K]) and the warm state ``warm`` (``x3tpu_torch.warm.WarmArrays``)
    where given.  Every lane's state lives in a zeroed scratch tensor
    allocated here (with the seeds and the warm tables written in) and,
    for the planes :func:`smem_plan` picks, in the CTA's shared memory, so
    new capacities only reallocate: the kernel takes them at run time.
    Launches on the current stream and waits for the result
    (:func:`launch_encode` does not wait)."""
    return _encode_with(text, tlen, params, caps, seeds=seeds, warm=warm)


def _encode_with(text: torch.Tensor, tlen: torch.Tensor, params: X3Params,
                 caps: CodecCaps, lib: Optional[ctypes.CDLL] = None,
                 phases: Optional[torch.Tensor] = None, seeds=None,
                 smem_mask: Optional[int] = None, warm=None):
    """:func:`encode_blocks_cuda` through ``lib`` (default: the main
    path's); ``phases`` (i64 [L, slots]) only with a library built with
    -DX3_PHASES (tools/k1_phases.py); ``smem_mask`` in place of
    :func:`smem_plan`'s (0: every plane global; tools/kernel_ab.py)."""
    lanes = _check_encode(text, tlen, params, caps)
    if lanes and int(tlen.max()) > caps.block_bytes:
        raise ValueError("a block is larger than caps.block_bytes")
    return launch_encode(text, tlen, params, caps, seeds, warm, lib=lib,
                         phases=phases, smem_mask=smem_mask).result()


def _check_encode(text, tlen, params: X3Params, caps: CodecCaps) -> int:
    lanes = text.shape[0] if isinstance(text, torch.Tensor) else 0
    _check("text", text, torch.uint8,
           (lanes, codec.text_bytes(params, caps)))
    _check("tlen", tlen, torch.int32, (lanes,))
    if tlen.device != text.device:
        raise ValueError("text and tlen must be on the same device")
    return lanes


def launch_encode(text: torch.Tensor, tlen: torch.Tensor, params: X3Params,
                  caps: CodecCaps, seeds=None, warm=None,
                  stream: Optional[torch.cuda.Stream] = None,
                  lib: Optional[ctypes.CDLL] = None,
                  phases: Optional[torch.Tensor] = None,
                  smem_mask: Optional[int] = None) -> Launch:
    """Allocate, seed and launch K1 on ``stream`` (default: the current
    stream of ``text``'s device) without waiting for it; the inputs as
    :func:`encode_blocks_cuda`'s, whose bound on ``tlen`` the caller has
    checked on the host (``codec.pack_blocks``).  Every tensor is made on
    ``stream``, so the allocator reuses a launch's scratch only for later
    work of the same stream."""
    lanes = _check_encode(text, tlen, params, caps)
    lib = lib or _load()["encoder"]
    dev = text.device
    with torch.cuda.device(dev):
        stream = stream or torch.cuda.current_stream(dev)
        with torch.cuda.stream(stream):
            scratch, k, warm_n = _seeded_scratch(
                lanes, caps, dev, seeds, False, lib, warm,
                _kernel_k1_words(lib, caps))
            words = torch.zeros((lanes, caps.out_words), dtype=torch.int32,
                                device=dev)
            byte_lens = torch.empty((lanes,), dtype=torch.int32, device=dev)
            counts = torch.empty((lanes, 5), dtype=torch.int32, device=dev)
            sizes = torch.empty((lanes, 5), dtype=torch.float32, device=dev)
            flags = torch.empty((lanes,), dtype=torch.int32, device=dev)
            if lanes:
                extra = () if phases is None else (phases.data_ptr(),)
                rc = lib.x3_encode(
                    text.data_ptr(), tlen.data_ptr(), lanes, text.shape[1],
                    params.max_match_count, params.window,
                    params.magic_factor1, params.magic_factor2,
                    int(params.nl_remap), caps.dict_cap, caps.pair_cap,
                    caps.ctx_items_cap, caps.ctx0_items_cap,
                    caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words,
                    smem_plan(params, caps).mask if smem_mask is None
                    else smem_mask, k, *warm_n, scratch.data_ptr(),
                    words.data_ptr(), byte_lens.data_ptr(),
                    counts.data_ptr(), sizes.data_ptr(), flags.data_ptr(),
                    stream.cuda_stream, *extra)
                if rc != 0:
                    raise RuntimeError(f"x3_encode launch failed: "
                                       f"cudaError {rc}")
                LAUNCHES["encoder"] += 1
    return Launch((words, byte_lens, counts, sizes, flags), stream,
                  _finish_encode)


def _finish_encode(words, byte_lens, counts, sizes, flags):
    if bool((flags & OF_STEPS).any()):
        raise RuntimeError("x3_encode: a lane ran more events than bytes")
    return (words.to(torch.int64) & 0xFFFFFFFF, byte_lens.to(torch.int64),
            counts.to(torch.int64), sizes, _overflow(flags))


def _overflow(flags: torch.Tensor) -> codec.Overflow:
    return codec.Overflow(
        dict=(flags & OF_DICT) != 0, ctx0=(flags & OF_CTX0) != 0,
        ctx1=(flags & OF_CTX1) != 0, pairs=(flags & OF_PAIRS) != 0,
        out=(flags & OF_OUT) != 0,
    )


def decode_blocks_cuda(words: torch.Tensor, byte_lens: torch.Tensor,
                       caps: CodecCaps, seeds=None, warm=None):
    """Decode L streams with kernel K2: ``words`` i32 [L, IW] (the streams'
    little-endian u32 words, bit for bit) and ``byte_lens`` i32 [L], both
    on one CUDA device, every lane from the encoder's dictionary ``seeds``
    and warm state ``warm`` where given.  Every lane's state lives in a
    zeroed scratch tensor allocated here (with the seeds and the warm
    tables written in).  A corrupt stream (a
    symbol value past its model's total) and a lane still decoding after
    block_bytes + 1 events (a valid stream emits a byte with every event
    but EOF) raise ValueError; nothing hangs on a corrupt stream.
    Launches on the current stream and waits for the result
    (:func:`launch_decode` does not wait)."""
    return _decode_with(words, byte_lens, caps, seeds=seeds, warm=warm)


def _decode_with(words: torch.Tensor, byte_lens: torch.Tensor,
                 caps: CodecCaps, lib: Optional[ctypes.CDLL] = None,
                 phases: Optional[torch.Tensor] = None, seeds=None,
                 warm=None):
    """:func:`decode_blocks_cuda` through ``lib`` (default: the main
    path's); ``phases`` (i64 [L, slots]) only with a library built with
    -DX3_DEC_PHASES (tools/k2_phases.py)."""
    return launch_decode(words, byte_lens, caps, seeds, warm, lib=lib,
                         phases=phases).result()


def launch_decode(words: torch.Tensor, byte_lens: torch.Tensor,
                  caps: CodecCaps, seeds=None, warm=None,
                  stream: Optional[torch.cuda.Stream] = None,
                  lib: Optional[ctypes.CDLL] = None,
                  phases: Optional[torch.Tensor] = None) -> Launch:
    """Allocate, seed and launch K2 on ``stream`` (default: the current
    stream of ``words``' device) without waiting for it; the inputs and
    the errors of :meth:`Launch.result` as :func:`decode_blocks_cuda`'s."""
    lanes = words.shape[0] if isinstance(words, torch.Tensor) else 0
    iw = words.shape[1] if lanes else 0
    _check("words", words, torch.int32, (lanes, iw))
    _check("byte_lens", byte_lens, torch.int32, (lanes,))
    if byte_lens.device != words.device:
        raise ValueError("words and byte_lens must be on the same device")
    if lanes and iw < 1:
        raise ValueError("words needs at least one column")
    lib = lib or _load()["decoder"]
    dev = words.device
    with torch.cuda.device(dev):
        stream = stream or torch.cuda.current_stream(dev)
        with torch.cuda.stream(stream):
            scratch, k, warm_n = _seeded_scratch(lanes, caps, dev, seeds,
                                                 True, warm=warm)
            out = torch.zeros((lanes, caps.block_bytes), dtype=torch.uint8,
                              device=dev)
            out_lens = torch.empty((lanes,), dtype=torch.int32, device=dev)
            counts = torch.empty((lanes, 5), dtype=torch.int32, device=dev)
            sizes = torch.empty((lanes, 5), dtype=torch.float32, device=dev)
            flags = torch.empty((lanes,), dtype=torch.int32, device=dev)
            if lanes:
                extra = () if phases is None else (phases.data_ptr(),)
                rc = lib.x3_decode(
                    words.data_ptr(), byte_lens.data_ptr(), lanes, iw,
                    caps.block_bytes, caps.dict_cap, caps.pair_cap,
                    caps.ctx_items_cap, caps.ctx0_items_cap,
                    caps.ctx_small_cap, caps.ctx_promo_rows, k, *warm_n,
                    scratch.data_ptr(), out.data_ptr(), out_lens.data_ptr(),
                    counts.data_ptr(), sizes.data_ptr(), flags.data_ptr(),
                    stream.cuda_stream, *extra)
                if rc != 0:
                    raise RuntimeError(f"x3_decode launch failed: "
                                       f"cudaError {rc}")
                LAUNCHES["decoder"] += 1
    return Launch((out, out_lens, counts, sizes, flags), stream,
                  functools.partial(_finish_decode, caps.block_bytes))


def _finish_decode(block_bytes, out, out_lens, counts, sizes, flags):
    # as the plain decoder: a corrupt symbol on a lane none of whose
    # capacities overflowed (an overflow is retried), then the bound
    state = OF_DICT | OF_CTX0 | OF_CTX1 | OF_PAIRS | OF_OUT
    if bool((((flags & OF_CORRUPT) != 0) & ((flags & state) == 0)).any()):
        raise codec.corrupt()
    if bool((flags & OF_STEPS).any()):
        raise codec.malformed(block_bytes + 1)
    return (out, out_lens.to(torch.int64), counts.to(torch.int64), sizes,
            _overflow(flags))
