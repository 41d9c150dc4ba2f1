"""Plain reference of the x3 stream format: the encoder and decoder that
decide the benchmark's ``correct``.

Written from the format's contract (the reference C binary's
``x3.c``, ``backend.c``, ``dict.c``, ``context.c``, ``tag_pair.c``,
``ac.c`` and ``bio.c``), in plain Python and NumPy.  It imports nothing of
the program under test.  The stream is fixed to the bit by the input and
the parameters, so the benchmark compares the program's streams with
these byte for byte.

What makes it fast enough to check megabyte blocks:

* The forward-window match counts (``backend.c``: how often each prefix
  of the text at a position repeats in the next ``window - 32`` bytes)
  are a pure function of the input.  :func:`candidates` computes them
  for every position at once, one length at a time, from exact dense ids
  of the L-byte strings (no hashing, so no collisions), and keeps only
  what the search needs: how many lengths pass the threshold.
* The threshold sweep stops at the first threshold that any length
  passes: the 1-byte prefix repeats at least as often as any longer one
  and is never vetoed.
* The dictionary's recency rank is a move-to-front (positions strictly
  increase, at most one entry is touched an event), so a rank is the
  number of entries used later, kept in a Fenwick tree over positions;
  the order-0 index model's cumulative frequencies are a Fenwick tree
  over ranks.
* The longest dictionary entry at a position is a walk through a map of
  every entry's prefixes.

Probabilities follow C's float arithmetic: each quotient and product is
computed in double and rounded to float32, which is the correctly rounded
float32 result (double has more than 2 x 24 + 2 bits).  ``precision=
"bf16"`` rounds them to bfloat16 instead: the benchmark's control, a mode
choice in the next precision below the format's, which gives a different
stream that still decodes.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

MAX_MATCH = 32
E_CTX0, E_CTX1, E_IDX1, E_NEW, E_EOF = range(5)
EVENT_INIT = (1024, 1024, 1, 1, 1)
TOP = 0x7FFFFFFF
FIRST_Q = 0x20000000
HALF = 0x40000000
THIRD_Q = 0x60000000
F32_EXACT = 1 << 24      # integers below it are exact in float32

_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


@dataclasses.dataclass(frozen=True)
class Params:
    """The encoder's parameters (the reference's flags ``-t -w -m -n -x``)."""

    max_match_count: int = 15   # -t
    window: int = 8192          # -w, in bytes
    magic_factor1: int = 4      # -m
    magic_factor2: int = 0      # -n
    nl_remap: bool = False      # -x

    def nl(self, length: int) -> int:
        if not self.nl_remap:
            return length
        return {1: 1, 2: 4, 3: 6, 4: 8}.get(length, 9999)


def f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (ties to even)."""
    return _F32.unpack(_F32.pack(x))[0]


def bf16(x: float) -> float:
    """``x`` rounded to float32, then to the nearest bfloat16."""
    u = _U32.unpack(_F32.pack(x))[0]
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return _F32.unpack(_U32.pack(u))[0]


ROUNDING = {"f32": f32, "bf16": bf16}


def candidates(buf: np.ndarray, size: int, window: int, t: int) -> np.ndarray:
    """For each position ``p < size``: how many match lengths the threshold
    sweep of ``backend.c`` may pick at ``p``, longest last.

    ``count[L]`` is the number of positions ``s`` in ``[p+1, p+window-32)``
    whose first ``L`` bytes equal ``buf[p:p+L]`` (``buf`` is the input
    padded with zeros).  The sweep stops at the threshold ``tc = min(t,
    count[1] - 1)``; the lengths it may pick are those with ``count[L] >
    tc``, which are ``1 .. k`` since ``count`` falls with ``L``.  ``k`` is 0
    where ``count[1] < 2``: the sweep finds nothing and picks length 1."""
    k = np.zeros(size, np.int8)
    n = len(buf) - MAX_MATCH + 1       # positions with all 32 bytes
    if size == 0 or window - MAX_MATCH <= 1:
        return k
    pos = np.arange(n, dtype=np.int64)
    hi = np.minimum(pos[:size] + (window - MAX_MATCH), n)
    ids = buf[:n].astype(np.int64)
    tc = live = None
    for length in range(1, MAX_MATCH + 1):
        if length == 1:
            key = ids * n + pos
            order = np.argsort(key)
        else:
            # dense ids of the L-byte strings from the (L-1)-byte ids
            x = ids * 256 + buf[length - 1 : length - 1 + n]
            order = np.argsort(x * n + pos)
            xs = x[order]
            new = np.empty(n, np.int64)
            new[0] = 0
            np.cumsum(xs[1:] != xs[:-1], out=new[1:])
            ids = np.empty(n, np.int64)
            ids[order] = new
        skey = ids[order] * n + order
        rank = np.empty(n, np.int64)
        rank[order] = pos
        cnt = np.searchsorted(skey, ids[:size] * n + hi) - rank[:size] - 1
        if length == 1:
            tc = np.minimum(t, cnt - 1)
            live = tc >= 1
        more = live & (cnt > tc)
        if not more.any():
            break
        k += more
    return k


class _Fenwick:
    """Prefix sums over ``n`` slots with point updates."""

    __slots__ = ("tree",)

    def __init__(self, n: int):
        self.tree = [0] * (n + 1)

    def add(self, i: int, v: int) -> None:
        tree = self.tree
        i += 1
        n = len(tree)
        while i < n:
            tree[i] += v
            i += i & -i

    def prefix(self, i: int) -> int:
        """Sum of slots ``[0, i)``."""
        tree = self.tree
        s = 0
        while i > 0:
            s += tree[i]
            i &= i - 1
        return s

    def search(self, value: int) -> int:
        """The slot ``j`` with ``prefix(j) <= value < prefix(j + 1)``
        (slots hold non-negative values)."""
        tree = self.tree
        j = 0
        step = 1 << (len(tree).bit_length() - 1)
        while step:
            nj = j + step
            if nj < len(tree) and tree[nj] <= value:
                j = nj
                value -= tree[nj]
            step >>= 1
        return j


def _pack_bits(bits: bytearray) -> bytes:
    """Bits, first written first, LSB-first into little-endian u32 words,
    the last word zero-padded (``bio.c``)."""
    if not bits:
        return b""
    out = np.packbits(np.frombuffer(bits, np.uint8), bitorder="little")
    return out.tobytes() + bytes(-len(out) % 4)


def encode(data: bytes, params: Params = Params(),
           precision: str = "f32") -> bytes:
    """The reference-format stream of ``data`` (``x3.c`` compress)."""
    rnd = ROUNDING[precision]
    size = len(data)
    buf = bytes(data) + bytes(max(params.window, MAX_MATCH))
    kmax = candidates(np.frombuffer(buf, np.uint8), size, params.window,
                      params.max_match_count).tolist()
    mf1, mf2 = params.magic_factor1, params.magic_factor2
    nl = params.nl

    bits = bytearray()
    low, high, scale = 0, TOP, 0

    def code(lf: int, hf: int, tot: int) -> None:
        nonlocal low, high, scale
        step = (high - low + 1) // tot
        high = low + step * hf - 1
        low = low + step * lf
        while high < HALF or low >= HALF:
            if high < HALF:
                bits.append(0)
                low = 2 * low
                high = 2 * high + 1
                if scale:
                    bits.extend(b"\x01" * scale)
                    scale = 0
            else:
                bits.append(1)
                low = 2 * (low - HALF)
                high = 2 * (high - HALF) + 1
                if scale:
                    bits.extend(b"\x00" * scale)
                    scale = 0
        while FIRST_Q <= low and high < THIRD_Q:
            scale += 1
            low = 2 * (low - FIRST_Q)
            high = 2 * (high - FIRST_Q) + 1

    def q(a: int, b: int) -> float:
        if b >= F32_EXACT:
            return rnd(rnd(a) / rnd(b))
        return rnd(a / b)

    # the dictionary: every prefix of every entry -> its tag, or -1 where
    # the prefix is no entry
    pmap: dict = {}
    tag_len: list = []
    tag_pos: list = []
    by_pos = _Fenwick(size + 1)        # entries by last use
    n_ent = 0
    ix = _Fenwick(size + 1)            # order-0 index model, by rank
    ixf: list = []
    ix_tot = 0
    ev = list(EVENT_INIT)
    ev_tot = sum(ev)
    msz = [1] * MAX_MATCH
    msz_tot = MAX_MATCH
    chars = [1] * 256
    ch_tot = 256
    pairs: dict = {}                   # (tag, tag) -> ctx0 row id
    ctx0: list = [None]                # row id -> [slots, freqs, total]
    ctx1: list = []                    # tag -> [slots, freqs, total]

    def longest(q_at: int):
        """(tag, length) of the longest entry that ``buf[q_at:]`` begins
        with, or (-1, 0)."""
        best, blen = -1, 0
        ln = 1
        while ln <= MAX_MATCH:
            v = pmap.get(buf[q_at : q_at + ln])
            if v is None:
                break
            if v >= 0:
                best, blen = v, ln
            ln += 1
        return best, blen

    prev_c1 = 0
    c1 = 0
    p = 0
    while p < size:
        tag, dlen = longest(p)
        # the window search with its two vetoes (backend.c)
        best = 1
        k = kmax[p]
        if k:
            memo = {}
            for i in range(k - 1, -1, -1):
                if i >= 2 and mf1 > 0:
                    d = memo.get(i)
                    if d is None:
                        d = memo[i] = longest(p + i)[1]
                    if d and d * mf1 > i + 1:
                        continue
                if i >= 1 and mf2 > 0:
                    vetoed = False
                    for o in range(1, i + 1):
                        d = memo.get(o)
                        if d is None:
                            d = memo[o] = longest(p + o)[1]
                        if d and (d - o) * mf2 > i + 1:
                            vetoed = True
                            break
                    if vetoed:
                        continue
                best = i + 1
                break
        if tag >= 0 and nl(dlen) >= best and p + dlen <= size:
            # a dictionary hit, coded in the cheapest of three ways
            lp = tag_pos[tag]
            rank = n_ent - by_pos.prefix(lp + 1)
            pid = pairs.get((prev_c1, c1), 0)
            row0 = ctx0[pid]
            if row0 is None:
                row0 = ctx0[pid] = [{}, [], 0]
            row1 = ctx1[c1] if c1 < len(ctx1) else None
            if row1 is None:
                row1 = [{}, [], 0]
                while len(ctx1) <= c1:
                    ctx1.append(None)
                ctx1[c1] = row1
            i0 = row0[0].get(tag)
            i1 = row1[0].get(tag)
            mode = E_IDX1
            prob = rnd(q(ev[E_IDX1], ev_tot) * q(ixf[rank], ix_tot))
            if i0 is not None:
                pr = rnd(q(ev[E_CTX0], ev_tot) * q(row0[1][i0], row0[2]))
                if pr > prob:
                    mode, prob = E_CTX0, pr
            if i1 is not None:
                pr = rnd(q(ev[E_CTX1], ev_tot) * q(row1[1][i1], row1[2]))
                if pr > prob:
                    mode = E_CTX1
            lf = sum(ev[:mode])
            code(lf, lf + ev[mode], ev_tot)
            ev[mode] += 1
            ev_tot += 1
            if mode == E_CTX0:
                fr = row0[1]
                lf = sum(fr[:i0])
                code(lf, lf + fr[i0], row0[2])
            elif mode == E_CTX1:
                fr = row1[1]
                lf = sum(fr[:i1])
                code(lf, lf + fr[i1], row1[2])
            else:
                lf = ix.prefix(rank)
                code(lf, lf + ixf[rank], ix_tot)
                ixf[rank] += 1
                ix.add(rank, 1)
                ix_tot += 1
            for row in (row0, row1):
                s = row[0].get(tag)
                if s is None:
                    row[0][tag] = len(row[1])
                    row[1].append(1)
                else:
                    row[1][s] += 1
                row[2] += 1
            if (c1, tag) not in pairs:
                pairs[(c1, tag)] = len(pairs)
                ctx0.append(None)
            prev_c1, c1 = c1, tag
            by_pos.add(lp, -1)
            by_pos.add(p, 1)
            tag_pos[tag] = p
            p += dlen
        else:
            # a literal fragment: its length, then its bytes
            length = min(best, size - p)
            lf = sum(ev[:E_NEW])
            code(lf, lf + ev[E_NEW], ev_tot)
            ev[E_NEW] += 1
            ev_tot += 1
            lf = sum(msz[: length - 1])
            code(lf, lf + msz[length - 1], msz_tot)
            msz[length - 1] += 1
            msz_tot += 1
            frag = buf[p : p + length]
            for b in frag:
                lf = sum(chars[:b])
                code(lf, lf + chars[b], ch_tot)
                chars[b] += 1
                ch_tot += 1
            if pmap.get(frag, -1) < 0:
                for ln in range(1, length):
                    pmap.setdefault(frag[:ln], -1)
                pmap[frag] = n_ent
                tag_len.append(length)
                tag_pos.append(p)
                by_pos.add(p, 1)
                ixf.append(1)
                ix.add(n_ent, 1)
                ix_tot += 1
                n_ent += 1
            prev_c1 = c1 = 0
            p += length
    lf = sum(ev[:E_EOF])
    code(lf, lf + ev[E_EOF], ev_tot)
    if low < FIRST_Q:
        bits.append(0)
        bits.extend(b"\x01" * (scale + 1))
    else:
        bits.append(1)
    return _pack_bits(bits)


class _Bits:
    """LSB-first reader over the stream's little-endian u32 words; past
    the readable words it reads the sentinel word 0x80000000 (``bio.c``:
    a word is readable if it starts before the last 3 bytes)."""

    def __init__(self, stream: bytes):
        n = (len(stream) - 4) // 4 + 1 if len(stream) >= 4 else 0
        words = np.frombuffer(stream[: 4 * n], "<u4").tolist()
        self.words = words
        self.w = 0
        self.acc = 0
        self.n = 32

    def bit(self) -> int:
        if self.n == 32:
            if self.w < len(self.words):
                self.acc = self.words[self.w]
                self.w += 1
            else:
                self.acc = 0x80000000
            self.n = 0
        b = self.acc & 1
        self.acc >>= 1
        self.n += 1
        return b


def decode(stream: bytes) -> bytes:
    """The data of a reference-format stream (``x3.c`` decompress).
    Raises ValueError on a stream that no encoder wrote."""
    src = _Bits(stream)
    low, high, buffer = 0, TOP, 0
    for _ in range(31):
        buffer = (buffer << 1) | src.bit()

    def narrow(lf: int, hf: int, step: int) -> None:
        nonlocal low, high, buffer
        high = low + step * hf - 1
        low = low + step * lf
        while high < HALF or low >= HALF:
            if high < HALF:
                low, high = 2 * low, 2 * high + 1
                buffer = 2 * buffer + src.bit()
            else:
                low, high = 2 * (low - HALF), 2 * (high - HALF) + 1
                buffer = 2 * (buffer - HALF) + src.bit()
        while FIRST_Q <= low and high < THIRD_Q:
            low, high = 2 * (low - FIRST_Q), 2 * (high - FIRST_Q) + 1
            buffer = 2 * (buffer - FIRST_Q) + src.bit()

    def sym_of(freqs: list, tot: int) -> int:
        step = (high - low + 1) // tot
        value = (buffer - low) // step
        if value < 0:
            raise ValueError("x3 stream: a value outside every interval")
        cum = 0
        for s, f in enumerate(freqs):
            if value < cum + f:
                narrow(cum, cum + f, step)
                return s
            cum += f
        raise ValueError("x3 stream: a value outside every interval")

    out = bytearray()
    strs: list = []
    known: dict = {}
    tag_pos: list = []
    pos_tag: dict = {}
    cap = 1 << 16
    by_pos = _Fenwick(cap)
    ix = _Fenwick(cap)
    ixf: list = []
    ix_tot = 0
    ev = list(EVENT_INIT)
    ev_tot = sum(ev)
    msz = [1] * MAX_MATCH
    msz_tot = MAX_MATCH
    chars = [1] * 256
    ch_tot = 256
    pairs: dict = {}
    ctx0: list = [[{}, [], [], 0]]
    ctx1: list = []

    def grow(n: int):
        nonlocal by_pos, ix, cap
        while n >= cap:
            cap *= 2
        nb, ni = _Fenwick(cap), _Fenwick(cap)
        for lp in tag_pos:
            nb.add(lp, 1)
        for r, f in enumerate(ixf):
            ni.add(r, f)
        by_pos, ix = nb, ni

    prev_c1 = c1 = 0
    while True:
        mode = sym_of(ev, ev_tot)
        ev[mode] += 1
        ev_tot += 1
        if mode == E_EOF:
            return bytes(out)
        if mode == E_NEW:
            length = sym_of(msz, msz_tot) + 1
            msz[length - 1] += 1
            msz_tot += 1
            frag = bytearray()
            for _ in range(length):
                b = sym_of(chars, ch_tot)
                chars[b] += 1
                ch_tot += 1
                frag.append(b)
            frag = bytes(frag)
            p = len(out)
            if frag not in known:
                if max(p + length, len(strs) + 1) >= cap:
                    grow(max(p + length, len(strs) + 1))
                known[frag] = len(strs)
                strs.append(frag)
                tag_pos.append(p)
                pos_tag[p] = len(strs) - 1
                by_pos.add(p, 1)
                ixf.append(1)
                ix.add(len(strs) - 1, 1)
                ix_tot += 1
                ctx1.append(None)
            out += frag
            prev_c1 = c1 = 0
            continue
        if mode > E_IDX1:
            raise ValueError(f"x3 stream: event {mode}")
        row0 = ctx0[pairs.get((prev_c1, c1), 0)]
        if c1 >= len(ctx1):
            raise ValueError("x3 stream: a context past the dictionary")
        if ctx1[c1] is None:
            ctx1[c1] = [{}, [], [], 0]
        row1 = ctx1[c1]
        if mode == E_CTX0:
            if not row0[2]:
                raise ValueError("x3 stream: an empty context")
            tag = row0[1][sym_of(row0[2], row0[3])]
        elif mode == E_CTX1:
            if not row1[2]:
                raise ValueError("x3 stream: an empty context")
            tag = row1[1][sym_of(row1[2], row1[3])]
        else:
            if not ixf:
                raise ValueError("x3 stream: an index into no dictionary")
            rank = sym_of(ixf, ix_tot) if len(ixf) < 64 else None
            if rank is None:
                step = (high - low + 1) // ix_tot
                value = (buffer - low) // step
                if not 0 <= value < ix_tot:
                    raise ValueError("x3 stream: a value outside every "
                                     "interval")
                rank = ix.search(value)
                lf = ix.prefix(rank)
                narrow(lf, lf + ixf[rank], step)
            ixf[rank] += 1
            ix.add(rank, 1)
            ix_tot += 1
            # the entry used rank-th most recently: the (n - rank)-th
            # smallest last use
            lp = by_pos.search(len(strs) - rank - 1)
            tag = pos_tag[lp]
        for row in (row0, row1):
            s = row[0].get(tag)
            if s is None:
                row[0][tag] = len(row[1])
                row[1].append(tag)
                row[2].append(1)
            else:
                row[2][s] += 1
            row[3] += 1
        if (c1, tag) not in pairs:
            pairs[(c1, tag)] = len(pairs)
            ctx0.append([{}, [], [], 0])
        prev_c1, c1 = c1, tag
        p = len(out)
        if p >= cap:
            grow(p)
        lp = tag_pos[tag]
        by_pos.add(lp, -1)
        del pos_tag[lp]
        by_pos.add(p, 1)
        pos_tag[p] = tag
        tag_pos[tag] = p
        out += strs[tag]
