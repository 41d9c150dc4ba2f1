"""The port's seed trainer on the host CPU (``x3tpu.host.train_seeds`` and
``train_tape``): ``csrc/x3_train.cpp``, built with g++ at first use into
``build/x3tpu_torch/`` and loaded with ctypes.  Without g++ it raises; it
never trains another way."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from x3tpu_torch import warm
from x3tpu_torch.config import MAX_MATCH_LEN, X3Params

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "x3_train.cpp"
BUILD_DIR = _PKG.parent / "build" / "x3tpu_torch"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> pathlib.Path:
    """The trainer's library for the current source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return BUILD_DIR / f"libx3train_{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib_path = library_path()
            if not lib_path.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError("x3tpu_torch: g++ not found (needed "
                                       "to build the seed trainer)")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(
                    f"{lib_path.stem}.{os.getpid()}.tmp.so")
                proc = subprocess.run(
                    [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ {SOURCE.name} failed "
                                       f"({proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            sz, i, lg, p = (ctypes.c_size_t, ctypes.c_int, ctypes.c_long,
                            ctypes.c_void_p)
            lib.x3h_train_ranked.restype = sz
            lib.x3h_train_ranked.argtypes = [ctypes.c_char_p, sz, i, lg, lg,
                                             lg, i, p, p, sz]
            lib.x3h_train_tape.restype = sz
            lib.x3h_train_tape.argtypes = [ctypes.c_char_p, sz, i, lg, lg, lg,
                                           i, p, p, sz, p, sz, p]
            _lib = lib
        return _lib


def train_seeds(data: bytes, params: X3Params = X3Params(),
                k: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """A seed dictionary from a sample, as ``x3tpu.host.train_seeds(...,
    ranked=True)`` makes it: up to ``k`` fragments the codec learned on it,
    by descending use count, so hot fragments start at low recency ranks
    in every seeded block.  Returns (strs u8 [n, 32], lens i32 [n]),
    strings zero-padded."""
    lib = _load()
    strs = np.zeros((k, MAX_MATCH_LEN), np.uint8)
    lens = np.zeros((k,), np.int32)
    n = lib.x3h_train_ranked(
        bytes(data), len(data), params.max_match_count, params.window,
        params.magic_factor1, params.magic_factor2,
        1 if params.nl_remap else 0, strs.ctypes.data, lens.ctypes.data, k)
    return strs[:n], lens[:n]


def train_tape(data: bytes, params: X3Params = X3Params(), k: int = 256,
               tape_cap: int = 0) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """The seeds of :func:`train_seeds` and the warm-start tape, as
    ``x3tpu.host.train_tape`` makes them: one entry a training event, the
    kept seed index of the hit's tag, or ``warm.RESET`` for a new fragment
    or a tag not kept; at most ``tape_cap`` (default ``warm.TAPE_MAX``)
    entries, the head of the sequence.  Returns (strs u8 [n, 32], lens i32
    [n], tape)."""
    lib = _load()
    strs = np.zeros((k, MAX_MATCH_LEN), np.uint8)
    lens = np.zeros((k,), np.int32)
    tape = np.zeros((tape_cap or warm.TAPE_MAX,), np.int32)
    tape_len = ctypes.c_size_t()
    n = lib.x3h_train_tape(
        bytes(data), len(data), params.max_match_count, params.window,
        params.magic_factor1, params.magic_factor2,
        1 if params.nl_remap else 0, strs.ctypes.data, lens.ctypes.data, k,
        tape.ctypes.data, len(tape), ctypes.byref(tape_len))
    return strs[:n], lens[:n], [warm.RESET if v < 0 else int(v)
                                for v in tape[: tape_len.value]]
