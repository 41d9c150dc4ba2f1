"""The CUDA kernel's per-lane core (``x3tpu_torch/csrc/x3_core.cuh``) built
for the host with g++, one thread per lane, and held against the golden
streams and the plain PyTorch encoder.  This is the only route to the
kernel's logic without a GPU; no module of the package uses this build."""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from x3tpu.config import X3Params
from x3tpu_torch import codec

from conftest import GOLDEN, PARAMSETS, golden_cases
from test_torch_codec import (OVERFLOW_FLAGS, SMALL_CAPS, TINY_CAPS,
                              TINY_PARAMS, _tiny_blocks, plain_tiny)
from test_torch_codec import one_thread  # noqa: F401  (autouse)

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
    for f in (src, CSRC / "x3_core.cuh"):
        h.update(f.read_bytes())
    out = ROOT / "build" / "x3tpu_torch" / f"libx3core_host_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x3h_encode.argtypes = [p, p, i, ctypes.c_longlong] + [i] * 12 + [p] * 5
    lib.x3h_encode.restype = i
    return lib


def _encode(lib, blocks, params, caps):
    """The host core's (words, byte_lens, counts, sizes, flags) as arrays."""
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
        caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words,
        words.ctypes.data, lens.ctypes.data, counts.ctypes.data,
        sizes.ctypes.data, flags.ctypes.data)
    assert rc == 0
    return words, lens, counts, sizes, flags


@pytest.mark.parametrize("pname", sorted(PARAMSETS))
def test_core_golden_streams(core, pname):
    names = [n for n, p in golden_cases() if p == pname]
    blocks = [(GOLDEN / f"{n}.bin").read_bytes() for n in names]
    words, lens, _, _, flags = _encode(core, blocks, X3Params(**PARAMSETS[pname]),
                                       SMALL_CAPS)
    assert not flags.any()
    for i, name in enumerate(names):
        got = words[i].tobytes()[: lens[i]]
        assert got == (GOLDEN / f"{name}.{pname}.x3").read_bytes(), name


def test_core_matches_plain_with_overflow(core):
    """Every output against the plain encoder, at capacities where the
    dictionary, both context families, the pair map and the output buffer
    overflow: the kernel's flag bits (x3_core.cuh OF_*) are x3tpu's
    Overflow fields, and the words of the lanes beside the one that
    overflows its buffer are untouched."""
    plain = plain_tiny()
    words, lens, counts, sizes, flags = _encode(core, _tiny_blocks(),
                                                TINY_PARAMS, TINY_CAPS)
    np.testing.assert_array_equal(words.astype(np.int64), plain[0].numpy())
    np.testing.assert_array_equal(lens, plain[1].numpy())
    np.testing.assert_array_equal(counts, plain[2].numpy())
    np.testing.assert_allclose(sizes, plain[3].numpy(), rtol=1e-5, atol=1e-3)
    for bit, name in enumerate(OVERFLOW_FLAGS):
        fired = (flags >> bit) & 1 == 1
        np.testing.assert_array_equal(fired, getattr(plain[4], name).numpy(),
                                      err_msg=name)
        assert fired.any(), name
