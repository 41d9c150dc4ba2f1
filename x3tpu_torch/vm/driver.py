"""Driver of the CUDA encoder kernel K1 (the encode half of
``x3tpu.vm.driver``): builds ``csrc/x3_encoder.cu`` with nvcc at first use,
loads it with ctypes, checks the inputs, allocates state and outputs, and
launches one kernel per wave.

:func:`encode_blocks_cuda` has the contract of
``x3tpu_torch.codec.encode_blocks_chunked``: (words [L, out_words] u32 in
int64, byte_lens, counts, sizes, Overflow).  Nothing falls back: a failed
build or launch raises, and so does a tensor that is not on a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import torch

from x3tpu.config import CodecCaps, X3Params
from x3tpu_torch import codec

# launches of each kernel since the last reset (the main-path check)
LAUNCHES = {"encoder": 0}

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "x3tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# per-lane flag bits written by the kernel (x3_core.cuh OF_*)
OF_DICT, OF_CTX0, OF_CTX1, OF_PAIRS, OF_OUT, OF_STEPS = 1, 2, 4, 8, 16, 32

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""   # nvcc's output of the build this process made (ptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("x3tpu_torch: nvcc not found (needed to build the "
                       "CUDA encoder kernel)")


def library_path() -> pathlib.Path:
    """The kernel library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"libx3enc_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless this source hash is already built; the
    library is renamed into place, so concurrent builds are safe."""
    global BUILD_LOG
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "x3_encoder.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    BUILD_LOG = r.stdout + r.stderr
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
            lib.x3_scratch_words.restype = ll
            lib.x3_scratch_words.argtypes = [i] * 6
            lib.x3_encode.restype = i
            lib.x3_encode.argtypes = [p, p, i, ll] + [i] * 12 + [p] * 7
            _lib = lib
        return _lib


def scratch_words(caps: CodecCaps) -> int:
    """int32 words of dictionary and context state one lane needs."""
    return _load().x3_scratch_words(
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap,
        caps.ctx0_items_cap, caps.ctx_small_cap, caps.ctx_promo_rows)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def encode_blocks_cuda(text: torch.Tensor, tlen: torch.Tensor,
                       params: X3Params, caps: CodecCaps):
    """Encode L blocks with kernel K1: ``text`` u8 [L, TB] from
    ``codec.pack_blocks`` and ``tlen`` i32 [L], both on one CUDA device.
    Every lane's state lives in a zeroed scratch tensor allocated here, so
    new capacities only reallocate: the kernel takes them at run time."""
    lanes = text.shape[0] if isinstance(text, torch.Tensor) else 0
    _check("text", text, torch.uint8,
           (lanes, codec.text_bytes(params, caps)))
    _check("tlen", tlen, torch.int32, (lanes,))
    if tlen.device != text.device:
        raise ValueError("text and tlen must be on the same device")
    if lanes and int(tlen.max()) > caps.block_bytes:
        raise ValueError("a block is larger than caps.block_bytes")
    lib = _load()
    dev = text.device
    with torch.cuda.device(dev):
        scratch = torch.zeros((lanes, scratch_words(caps)), dtype=torch.int32,
                              device=dev)
        words = torch.zeros((lanes, caps.out_words), dtype=torch.int32,
                            device=dev)
        byte_lens = torch.empty((lanes,), dtype=torch.int32, device=dev)
        counts = torch.empty((lanes, 5), dtype=torch.int32, device=dev)
        sizes = torch.empty((lanes, 5), dtype=torch.float32, device=dev)
        flags = torch.empty((lanes,), dtype=torch.int32, device=dev)
        if lanes:
            rc = lib.x3_encode(
                text.data_ptr(), tlen.data_ptr(), lanes, text.shape[1],
                params.max_match_count, params.window, params.magic_factor1,
                params.magic_factor2, int(params.nl_remap), caps.dict_cap,
                caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
                caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words,
                scratch.data_ptr(), words.data_ptr(), byte_lens.data_ptr(),
                counts.data_ptr(), sizes.data_ptr(), flags.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"x3_encode launch failed: cudaError {rc}")
            LAUNCHES["encoder"] += 1
        if bool((flags & OF_STEPS).any()):
            raise RuntimeError("x3_encode: a lane ran more events than bytes")
    overflow = codec.Overflow(
        dict=(flags & OF_DICT) != 0, ctx0=(flags & OF_CTX0) != 0,
        ctx1=(flags & OF_CTX1) != 0, pairs=(flags & OF_PAIRS) != 0,
        out=(flags & OF_OUT) != 0,
    )
    return (words.to(torch.int64) & 0xFFFFFFFF, byte_lens.to(torch.int64),
            counts.to(torch.int64), sizes, overflow)
