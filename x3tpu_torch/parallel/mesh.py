"""Lane groups over the local devices: the port of ``x3tpu.parallel.mesh``
and of x3tpu's sharded VM drivers (``x3tpu/vm/driver.py``
``encode_blocks_vm_sharded`` / ``decode_blocks_vm_sharded``).

x3tpu shards a wave over a 1-D ``blocks`` mesh (``P("blocks")``): device
i runs the i-th contiguous group of L / nd lanes, and the dictionary seeds
and the warm state go to every device (``P()``; x3tpu/parallel/
runtime.py:355, 386).  Here a :class:`Mesh` is a tuple of
``torch.device`` entries, each CUDA entry with a stream of its own.
:func:`encode_sharded` and :func:`decode_sharded` launch every group, each
as launches of at most :func:`launch_lanes` lanes, before they read any
result; then they wait, check every group's flags and join the groups on
the host in lane order.  An entry may repeat: two entries on one card run
on two streams side by side and share the card's memory (the counterpart
of x3tpu's virtual CPU devices).  CPU entries run the plain PyTorch codec,
one group after another.  One host thread does it all: a launch returns
at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from x3tpu_torch import codec
from x3tpu_torch.config import CodecCaps, X3Params, resolve_device
from x3tpu_torch.vm import driver

# the share of a card's total memory one launch's lanes may take, split
# evenly among the mesh entries on that card (the rest: the wave's inputs
# and outputs, PyTorch's allocator, other work)
MEM_SHARE = 0.75


class LaunchMemoryError(RuntimeError):
    """One lane needs more device memory than a launch may take."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the block-parallel axis: entry i runs the i-th
    contiguous lane group of a wave on ``devices[i]``, on ``streams[i]``
    (None: the device's current stream; always None for the CPU)."""

    devices: Tuple[torch.device, ...]
    streams: Tuple[Optional[torch.cuda.Stream], ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def single(device: torch.device) -> Mesh:
    """The one-device wave: ``device`` alone, on its current stream."""
    return Mesh((device,), (None,))


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every local CUDA device), its
    first ``num_devices`` where given.  An entry may repeat, and ``"cpu"``
    entries run the plain codec; CUDA and CPU entries do not mix.  Asking
    for more devices than there are, or for a CUDA device that does not
    exist, raises: nothing runs on fewer."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("x3tpu_torch: no CUDA device for the mesh "
                               "(devices=['cpu', ...] runs the plain codec)")
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [resolve_device(d) for d in devices]
    if num_devices is not None:
        if not 1 <= num_devices <= len(devices):
            raise ValueError(f"x3tpu_torch: {num_devices} devices asked "
                             f"for, {len(devices)} available")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("x3tpu_torch: a mesh needs a device")
    if len({d.type for d in devices}) > 1:
        raise ValueError("x3tpu_torch: a mesh is all CUDA or all CPU")
    out = []
    for d in devices:
        if d.type == "cuda":
            index = torch.cuda.current_device() if d.index is None else d.index
            if not 0 <= index < torch.cuda.device_count():
                raise ValueError(f"x3tpu_torch: no device cuda:{index} "
                                 f"({torch.cuda.device_count()} present)")
            d = torch.device("cuda", index)
        out.append(d)
    return Mesh(tuple(out), tuple(torch.cuda.Stream(d) if d.type == "cuda"
                                  else None for d in out))


def launch_lanes(lane_bytes: int, caps: CodecCaps, device: torch.device,
                 mem_budget: Optional[int] = None, sharing: int = 1) -> int:
    """Lanes a launch may hold: ``mem_budget`` bytes (default: MEM_SHARE of
    the card's total memory over the ``sharing`` mesh entries on that
    card, so the count never depends on what else holds memory; on the
    CPU, no bound) over ``lane_bytes``, the bytes one lane takes
    (``driver.encoder_lane_bytes`` / ``decoder_lane_bytes``).  x3tpu fits
    its lanes to the chip with ``set_active_lanes`` and sub-batches; here
    a lane group runs as consecutive launches of at most this many lanes.
    Raises LaunchMemoryError when one lane does not fit: capacities are
    never cut to make it."""
    if mem_budget is None:
        if device.type != "cuda":
            return 1 << 30
        mem_budget = int(MEM_SHARE * torch.cuda.get_device_properties(
            device).total_memory) // sharing
    lanes = mem_budget // lane_bytes
    if lanes < 1:
        raise LaunchMemoryError(
            f"one lane needs {lane_bytes} bytes of device memory at {caps}, "
            f"more than a launch may take ({mem_budget} bytes)")
    return lanes


def _on_host(run):
    """A launch's tuple on the host: a CUDA :class:`driver.Launch` waited
    for and copied on its own stream; a CPU result as it is."""
    if not isinstance(run, driver.Launch):
        return run
    out = run.result()
    with torch.cuda.device(run.stream.device), torch.cuda.stream(run.stream):
        return (*(t.cpu() for t in out[:4]),
                codec.Overflow(*(f.cpu() for f in out[4])))


def _sharded(lanes: int, mesh: Mesh, lane_bytes: int, caps: CodecCaps,
             mem_budget: Optional[int], launch):
    """Run ``launch(device, stream, lo, hi)`` over each entry's lane group
    in slices of at most :func:`launch_lanes` lanes, every launch before
    any result is read, and join the results (tensors, then the Overflow)
    on the host in lane order."""
    if lanes < 1 or lanes % mesh.size:
        raise ValueError(f"{lanes} lanes do not shard evenly over "
                         f"{mesh.size} devices")
    group = lanes // mesh.size
    runs = []
    for i, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
        per = launch_lanes(lane_bytes, caps, dev, mem_budget,
                           mesh.devices.count(dev))
        end = (i + 1) * group
        for lo in range(i * group, end, per):
            runs.append(launch(dev, stream, lo, min(lo + per, end)))
    outs = [_on_host(r) for r in runs]
    if len(outs) == 1:
        return outs[0]
    joined = [torch.cat([o[k] for o in outs]) for k in range(4)]
    overflow = codec.Overflow(*(torch.cat([getattr(o[4], f) for o in outs])
                                for f in codec.Overflow._fields))
    return (*joined, overflow)


def encode_sharded(text: np.ndarray, tlen: np.ndarray, params: X3Params,
                   caps: CodecCaps, mesh: Mesh, seeds=None,
                   mem_budget: Optional[int] = None, warm=None):
    """Encode one packed wave (``codec.pack_blocks``; its lanes a multiple
    of the mesh size) over ``mesh``: kernel K1 on CUDA entries, the plain
    PyTorch encoder on CPU entries, every lane from ``seeds`` and the warm
    state ``warm`` (``x3tpu_torch.warm.WarmArrays``) where given.
    ``mem_budget``: the bytes of one launch (default: :func:`launch_lanes`'
    share of the card).  Returns ``codec.encode_blocks_chunked``'s tuple
    on the host."""

    def launch(dev, stream, lo, hi):
        if dev.type != "cuda":
            return codec.encode_blocks_chunked(
                torch.from_numpy(text[lo:hi]), torch.from_numpy(tlen[lo:hi]),
                params, caps, seeds, warm)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            return driver.launch_encode(
                driver.to_device(text[lo:hi], dev),
                driver.to_device(tlen[lo:hi], dev), params, caps, seeds,
                warm, stream=stream)

    return _sharded(len(tlen), mesh, driver.encoder_lane_bytes(params, caps),
                    caps, mem_budget, launch)


def decode_sharded(words: np.ndarray, byte_lens: np.ndarray, caps: CodecCaps,
                   mesh: Mesh, seeds=None, mem_budget: Optional[int] = None,
                   warm=None):
    """Decode one packed wave (``words`` u32 [L, IW]; L a multiple of the
    mesh size) over ``mesh``: kernel K2 on CUDA entries, the plain PyTorch
    decoder on CPU entries, every lane from the encoder's ``seeds`` and
    ``warm`` where given.  Returns ``codec.decode_blocks_chunked``'s
    tuple on the host; a corrupt or endless stream raises as there."""

    def launch(dev, stream, lo, hi):
        if dev.type != "cuda":
            return codec.decode_blocks_chunked(
                torch.from_numpy(words[lo:hi].astype(np.int64)),
                torch.from_numpy(byte_lens[lo:hi]), caps, seeds, warm)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            return driver.launch_decode(
                driver.to_device(words[lo:hi].view(np.int32), dev),
                driver.to_device(byte_lens[lo:hi], dev), caps, seeds,
                warm, stream=stream)

    return _sharded(len(byte_lens), mesh,
                    driver.decoder_lane_bytes(caps, words.shape[1]), caps,
                    mem_budget, launch)
