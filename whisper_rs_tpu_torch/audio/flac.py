"""Pure-Python FLAC decoder (+ a minimal encoder for test fixtures); a copy
of ``whisper_rs_tpu/audio/flac.py``, which the port keeps so that it
imports nothing of the JAX package.

Decodes standard FLAC streams — constant / verbatim /
fixed / LPC subframes, Rice & Rice2 residual partitions (incl. escape
codes), wasted bits, independent and left/right/mid-side stereo
decorrelation, 8/16/24/32-bit sample sizes.

Host-side decode (like every ingest path here — audio never touches the
device until it is a float buffer).  The in-tree encoder emits valid FLAC with
verbatim or fixed-predictor subframes + Rice residuals, used by the test
suite as there is no FLAC tooling in the image.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _BitReader:
    def __init__(self, data: bytes, pos_bytes: int = 0):
        self.data = data
        self.pos = pos_bytes * 8  # bit position

    def read(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        n = 0
        pos = self.pos
        data = self.data
        while True:
            byte = data[pos >> 3]
            bit = (byte >> (7 - (pos & 7))) & 1
            pos += 1
            if bit:
                break
            n += 1
        self.pos = pos
        return n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_utf8_coded(self) -> int:
        """UTF-8-style variable length number (frame header)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        n_extra = 0
        mask = 0x40
        while b0 & mask:
            n_extra += 1
            mask >>= 1
        v = b0 & (mask - 1)
        for _ in range(n_extra):
            v = (v << 6) | (self.read(8) & 0x3F)
        return v


_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384,
    15: 32768,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class _FrameBits:
    """Whole-stream bit view for vectorized decode.

    ``ones`` holds the sorted positions of set bits; ``win64`` holds, for
    every byte offset i, the big-endian 64-bit window starting at byte i —
    so any ≤56-bit field at bit position p is one gather plus shift/mask.
    """

    def __init__(self, data: bytes):
        b = np.frombuffer(data + b"\x00" * 8, np.uint8)
        self.bits = np.unpackbits(b)  # incl. 64 zero pad bits
        self.ones = np.flatnonzero(self.bits)
        # prefix count: csum[x] = number of set bits at positions <= x
        # (int32: ~10x faster cumsum than int64; fine below 2^31 set bits)
        self.csum = np.cumsum(self.bits, dtype=np.int32)
        w = np.zeros(len(b) - 7, np.uint64)
        for i in range(8):
            w |= b[i : len(b) - 7 + i].astype(np.uint64) << np.uint64(
                8 * (7 - i)
            )
        self.win64 = w

    def _fields(self, starts: np.ndarray, width: int) -> np.ndarray:
        """Extract a width-bit (≤56) big-endian field at each bit position
        in ``starts`` -> uint64 values."""
        byte_idx = starts >> 3
        bitoff = (starts & 7).astype(np.uint64)
        shift = np.uint64(64 - width) - bitoff
        return (self.win64[byte_idx] >> shift) & np.uint64((1 << width) - 1)

    def read_fixed(self, pos: int, n: int, width: int, signed: bool = True):
        """n consecutive width-bit big-endian fields -> (int64[n], new_pos)."""
        if width == 0 or n == 0:
            return np.zeros(n, np.int64), pos
        starts = pos + np.arange(n, dtype=np.int64) * width
        v = self._fields(starts, width).astype(np.int64)
        if signed and width < 64:
            v = np.where(v >= (1 << (width - 1)), v - (1 << width), v)
        return v, pos + n * width

    def rice_decode(self, pos: int, n: int, k: int):
        """n Rice(k)-coded residuals starting at bit ``pos``.

        Stop-bit positions are found without any per-sample Python loop:
        from each set bit, the *next* stop bit is the first set bit at
        least k+1 later (skipping the k remainder bits), a relation
        computed for every candidate at once with searchsorted and then
        chased for all n samples in log2(n) binary-jumping rounds.
        """
        ones, csum = self.ones, self.csum
        j0 = int(csum[pos - 1]) if pos else 0  # ones strictly before pos
        # candidate window: typical streams set ~half the remainder bits;
        # grow geometrically toward the worst case n*(k+1) if exhausted
        guess = n * (2 + k // 2) + 1
        while True:
            hi = min(len(ones), j0 + guess)
            sub = ones[j0:hi]
            if len(sub) < n:
                raise ValueError("truncated Rice partition")
            # local index of each candidate's successor stop: the count of
            # set bits at positions <= sub[j]+k, re-based to this window
            sentinel = len(sub)
            nxt = np.empty(len(sub) + 1, np.int32)
            np.minimum(csum[sub + k] - j0, sentinel, out=nxt[:-1])
            nxt[-1] = sentinel  # sentinel maps to itself
            path = np.empty(n, np.int32)
            path[0] = 0
            filled = 1
            jump = nxt  # jump[i] = index after 2^r successor steps
            while filled < n:
                m = min(filled, n - filled)
                path[filled : filled + m] = jump[path[:m]]
                filled += m
                if filled < n:
                    jump = jump[jump]
            if path[-1] < sentinel:
                break
            if hi == len(ones) or guess >= n * (k + 1) + 1:
                raise ValueError("truncated Rice partition")
            guess = min(guess * 4, n * (k + 1) + 1)
        stops = sub[path]
        q = np.empty(n, np.int64)
        q[0] = stops[0] - pos
        q[1:] = stops[1:] - stops[:-1] - (k + 1)
        if k:
            rem = self._fields(stops + 1, k).astype(np.int64)
            u = (q << k) | rem
        else:
            u = q
        vals = (u >> 1) ^ -(u & 1)  # zigzag
        return vals, int(stops[-1]) + 1 + k


def _integrate_fixed(warmup: np.ndarray, resid: np.ndarray, order: int):
    """Fixed-predictor reconstruction: a fixed predictor of order m means
    the m-th difference of the signal equals the residual, so decode is m
    rounds of seeded cumulative sum (exact in int64)."""
    if order == 0:
        return resid.astype(np.int64)
    warmup = warmup.astype(np.int64)
    cur = resid.astype(np.int64)
    for j in range(order, 0, -1):
        seed = np.diff(warmup, j - 1)[-1] if j > 1 else warmup[-1]
        cur = seed + np.cumsum(cur)
    return np.concatenate([warmup, cur])


def _decode_residual_v(fb: _FrameBits, br: _BitReader, blocksize: int,
                       order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    parts = []
    for p in range(n_parts):
        n = (blocksize >> part_order) - (order if p == 0 else 0)
        param = br.read(plen)
        if n == 0:
            continue
        if param == escape:
            width = br.read(5)
            vals, br.pos = fb.read_fixed(br.pos, n, width)
        else:
            vals, br.pos = fb.rice_decode(br.pos, n, param)
        parts.append(vals)
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _decode_subframe(fb: _FrameBits, br: _BitReader, blocksize: int,
                     bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("invalid subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if sf_type == 0:  # constant
        v = br.read_signed(bps)
        samples = np.full(blocksize, v, np.int64)
    elif sf_type == 1:  # verbatim
        samples, br.pos = fb.read_fixed(br.pos, blocksize, bps)
    elif 8 <= sf_type <= 12:  # fixed
        order = sf_type - 8
        warmup, br.pos = fb.read_fixed(br.pos, order, bps)
        resid = _decode_residual_v(fb, br, blocksize, order)
        samples = _integrate_fixed(warmup, resid, order)
    elif sf_type >= 32:  # LPC
        order = (sf_type & 31) + 1
        warmup, br.pos = fb.read_fixed(br.pos, order, bps)
        precision = br.read(4) + 1
        shift = br.read_signed(5)
        coefs_a, br.pos = fb.read_fixed(br.pos, order, precision)
        resid = _decode_residual_v(fb, br, blocksize, order)
        # integer IIR: genuinely sequential; plain-int loop with reversed
        # coefficients is the fastest pure-Python form
        hist = [int(v) for v in warmup]
        coefs = [int(c) for c in coefs_a[::-1]]  # oldest-first
        rng = range(order)
        for r in resid.tolist():
            acc = 0
            for i in rng:
                acc += coefs[i] * hist[i - order]
            hist.append((acc >> shift) + r)
        samples = np.asarray(hist, np.int64)
    else:
        raise ValueError(f"reserved subframe type {sf_type}")

    if wasted:
        samples = samples << wasted
    return samples


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 [n, channels], sample_rate)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = None
    n_channels = None
    bps = None
    total = None
    while True:
        hdr = data[pos]
        block_type = hdr & 0x7F
        last = bool(hdr & 0x80)
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if block_type == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)  # min frame
            br.read(24)  # max frame
            sample_rate = br.read(20)
            n_channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise ValueError("missing STREAMINFO")

    fb = _FrameBits(data)
    channels: List[List[np.ndarray]] = [[] for _ in range(n_channels)]
    while pos < len(data) - 2:
        br = _BitReader(data, pos)
        sync = br.read(14)
        if sync != 0x3FFE:
            break
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        chan_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        br.read_utf8_coded()

        if bs_code == 6:
            blocksize = None  # read after header
        elif bs_code == 7:
            blocksize = None
        else:
            blocksize = _BLOCK_SIZES[bs_code]
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        frame_bps = _SAMPLE_SIZES.get(ss_code, bps)
        br.read(8)  # CRC-8

        if chan_code < 8:
            n_ch = chan_code + 1
            subs = [
                _decode_subframe(fb, br, blocksize, frame_bps)
                for _ in range(n_ch)
            ]
        elif chan_code == 8:  # left/side
            left = _decode_subframe(fb, br, blocksize, frame_bps)
            side = _decode_subframe(fb, br, blocksize, frame_bps + 1)
            subs = [left, left - side]
        elif chan_code == 9:  # right/side
            side = _decode_subframe(fb, br, blocksize, frame_bps + 1)
            right = _decode_subframe(fb, br, blocksize, frame_bps)
            subs = [right + side, right]
        elif chan_code == 10:  # mid/side
            mid = _decode_subframe(fb, br, blocksize, frame_bps)
            side = _decode_subframe(fb, br, blocksize, frame_bps + 1)
            mm = (mid << 1) | (side & 1)
            subs = [(mm + side) >> 1, (mm - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {chan_code}")

        for c, sub in enumerate(subs):
            channels[c].append(sub)

        br.align()
        br.read(16)  # CRC-16
        pos = br.pos >> 3

    cat = [np.concatenate(c) if c else np.zeros(0, np.int64) for c in channels]
    n = min(len(c) for c in cat)
    if total:
        n = min(n, total)
    arr = np.stack([c[:n] for c in cat], axis=1).astype(np.float64)
    scale = float(1 << (bps - 1))
    return (arr / scale).astype(np.float32), sample_rate


# ---------------------------------------------------------------------------
# minimal encoder (test fixtures)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def write(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def write_signed(self, v: int, n: int) -> None:
        self.write(v & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        self.bits.extend([0] * q)
        self.bits.append(1)

    def align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def tobytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _encode_residual(bw: _BitWriter, resid: List[int], rice_param: int) -> None:
    bw.write(0, 2)  # rice method
    bw.write(0, 4)  # partition order 0
    bw.write(rice_param, 4)
    for r in resid:
        u = (r << 1) if r >= 0 else ((-r) << 1) - 1  # zigzag
        q, rem = u >> rice_param, u & ((1 << rice_param) - 1)
        bw.write_unary(q)
        if rice_param:
            bw.write(rem, rice_param)


def encode_flac(
    audio: np.ndarray, sample_rate: int, *, fixed_order: int = 2, bps: int = 16
) -> bytes:
    """float32 [n] or [n, ch] -> FLAC bytes (fixed-predictor subframes with
    Rice residuals; order 0 == verbatim-style)."""
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = np.round(pcm * ((1 << (bps - 1)) - 1)).astype(np.int64)
    n, n_ch = pcm.shape
    blocksize = 4096

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = _BitWriter()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(n_ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.tobytes() + b"\x00" * 16  # md5 zeroed (decoder ignores)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    frame_idx = 0
    for start in range(0, n, blocksize):
        block = pcm[start : start + blocksize]
        bsz = block.shape[0]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocksize strategy
        bw.write(7, 4)  # blocksize: 16-bit field follows
        bw.write(0, 4)  # sample rate: from STREAMINFO
        bw.write(n_ch - 1, 4)  # independent channels
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
        bw.write(ss_code, 3)
        bw.write(0, 1)
        # UTF-8 frame number (frames are small ints here)
        fn = frame_idx
        if fn < 0x80:
            bw.write(fn, 8)
        else:
            bw.write(0xC0 | (fn >> 6), 8)
            bw.write(0x80 | (fn & 0x3F), 8)
        bw.write(bsz - 1, 16)
        bw.write(0, 8)  # CRC-8 (decoder skips verification)

        for c in range(n_ch):
            ch = [int(v) for v in block[:, c]]
            order = min(fixed_order, bsz - 1, 4)
            bw.write(0, 1)
            bw.write(8 + order, 6)  # fixed subframe of given order
            bw.write(0, 1)  # no wasted bits
            for i in range(order):
                bw.write_signed(ch[i], bps)
            coefs = _FIXED_COEFS[order]
            resid = []
            for t in range(order, bsz):
                pred = sum(co * ch[t - i - 1] for i, co in enumerate(coefs))
                resid.append(ch[t] - pred)
            # pick a reasonable rice parameter
            mean_abs = max(1, int(np.mean(np.abs(resid))) if resid else 1)
            param = min(14, max(0, int(np.ceil(np.log2(mean_abs + 1)))))
            _encode_residual(bw, resid, param)

        bw.align()
        bw.write(0, 16)  # CRC-16 (decoder skips verification)
        out += bw.tobytes()
        frame_idx += 1

    return bytes(out)
