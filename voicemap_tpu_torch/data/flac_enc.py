"""Pure-Python FLAC encoder, for tests and the synthetic corpus.

A copy of ``voicemap_tpu/data/flac_enc.py``: the same streams, byte for
byte (``tests/test_torch_data_layer.py`` holds the two equal). It emits
RFC 9639 streams that cover every path of the decoder
(``flac/flac_decoder.cpp``): CONSTANT, VERBATIM, FIXED 0-4 and LPC
subframes, Rice and Rice2 residuals with a chosen partition order, escape
(raw) partitions, wasted bits, and left/side stereo. It is never on the
training path.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int):
        if bits == 0:
            return
        value &= (1 << bits) - 1
        self.acc = (self.acc << bits) | value
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a one

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    if n < 0x800:
        lead, extra = 0xC0, 1
    elif n < 0x10000:
        lead, extra = 0xE0, 2
    elif n < 0x200000:
        lead, extra = 0xF0, 3
    elif n < 0x4000000:
        lead, extra = 0xF8, 4
    elif n < 0x80000000:
        lead, extra = 0xFC, 5
    else:
        lead, extra = 0xFE, 6
    for i in range(extra):
        out.append(0x80 | ((n >> (6 * i)) & 0x3F))
    shift = 6 * extra
    first = lead | (n >> shift)
    return bytes([first] + out[::-1])


FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _zigzag(r: np.ndarray) -> np.ndarray:
    r = r.astype(np.int64)
    return np.where(r >= 0, 2 * r, -2 * r - 1)


def _best_rice_param(u: np.ndarray, max_param: int) -> int:
    if len(u) == 0:
        return 0
    mean = float(u.mean())
    p = 0
    while p < max_param and (1 << (p + 1)) < mean + 1:
        p += 1
    return p


def _write_residual(
    bw: BitWriter,
    res: np.ndarray,
    block_size: int,
    order: int,
    partition_order: int = 0,
    rice2: bool = False,
    force_escape: bool = False,
):
    method = 1 if rice2 else 0
    param_bits = 5 if rice2 else 4
    escape = 31 if rice2 else 15
    max_param = escape - 1
    bw.write(method, 2)
    # Partition order must divide the block evenly and keep partition 0
    # non-negative after removing warmup samples.
    while partition_order > 0 and (
        block_size % (1 << partition_order) != 0
        or (block_size >> partition_order) <= order
    ):
        partition_order -= 1
    bw.write(partition_order, 4)
    partitions = 1 << partition_order
    part_len = block_size >> partition_order
    idx = 0
    for p in range(partitions):
        count = part_len - (order if p == 0 else 0)
        chunk = res[idx : idx + count]
        idx += count
        u = _zigzag(chunk)
        if force_escape:
            m = int(np.abs(chunk).max()) if len(chunk) else 0
            raw_bits = min(max(1, m).bit_length() + 1, 31)
            bw.write(escape, param_bits)
            bw.write(raw_bits, 5)
            for v in chunk:
                bw.write_signed(int(v), raw_bits)
        else:
            param = _best_rice_param(u, max_param)
            bw.write(param, param_bits)
            for uv in u:
                q = int(uv) >> param
                bw.write_unary(q)
                bw.write(int(uv) & ((1 << param) - 1), param)


def _lpc_order2(x: np.ndarray, precision: int = 12):
    """Quantized order-2 LPC coefficients via Levinson-Durbin."""
    xf = x.astype(np.float64)
    n = len(xf)
    if n < 8:
        return None
    ac = [float(np.dot(xf[: n - k], xf[k:])) for k in range(3)]
    if ac[0] == 0:
        return None
    # Levinson-Durbin order 2.
    err = ac[0]
    a1 = ac[1] / err
    err *= 1 - a1 * a1
    if err <= 0:
        return None
    k2 = (ac[2] - a1 * ac[1]) / err
    c2 = -k2
    c1 = a1 - a1 * k2
    # Levinson-Durbin step 2: a2(1) = a1·(1 − k2), a2(2) = k2. Any quantized
    # coefficients yield a valid stream — the residual below is computed with
    # the decoder's exact integer prediction formula, so prediction quality
    # only affects compression ratio, never correctness.
    coefs = [a1 * (1 - k2), k2]
    shift = precision - 1
    q = [int(round(c * (1 << shift))) for c in coefs]
    lim = (1 << (precision - 1)) - 1
    q = [max(-lim - 1, min(lim, v)) for v in q]
    if all(v == 0 for v in q):
        return None
    return q, precision, shift


def _encode_subframe(
    bw: BitWriter,
    x: np.ndarray,
    bps: int,
    mode: str = "fixed",
    partition_order: int = 0,
    rice2: bool = False,
    force_escape: bool = False,
    wasted_bits: int = 0,
):
    bw.write(0, 1)  # padding
    eff = x
    if wasted_bits:
        assert np.all((x & ((1 << wasted_bits) - 1)) == 0), "wasted bits must be real"
        eff = x >> wasted_bits
    eff_bps = bps - wasted_bits

    def write_wasted():
        if wasted_bits:
            bw.write(1, 1)
            bw.write_unary(wasted_bits - 1)
        else:
            bw.write(0, 1)

    if mode == "constant" or (mode == "fixed" and np.all(eff == eff[0])):
        bw.write(0b000000, 6)
        write_wasted()
        bw.write_signed(int(eff[0]), eff_bps)
        return
    if mode == "verbatim":
        bw.write(0b000001, 6)
        write_wasted()
        for v in eff:
            bw.write_signed(int(v), eff_bps)
        return
    if mode == "lpc":
        got = _lpc_order2(eff)
        if got is not None:
            q, precision, shift = got
            order = 2
            bw.write(0b100000 | (order - 1), 6)
            write_wasted()
            for v in eff[:order]:
                bw.write_signed(int(v), eff_bps)
            bw.write(precision - 1, 4)
            bw.write_signed(shift, 5)
            for c in q:
                bw.write_signed(c, precision)
            e = eff.astype(np.int64)
            pred = (q[0] * e[order - 1 : -1] + q[1] * e[order - 2 : -2]) >> shift
            res = e[order:] - pred
            _write_residual(bw, res, len(eff), order, partition_order, rice2, force_escape)
            return
        mode = "fixed"  # degenerate signal: fall through
    # FIXED: pick the order with the smallest residual magnitude.
    best_order, best_res, best_cost = 0, eff.astype(np.int64), None
    for order in range(0, 5):
        if order >= len(eff):
            break
        res = _fixed_residual(eff, order)
        cost = float(np.abs(res).sum())
        if best_cost is None or cost < best_cost:
            best_order, best_res, best_cost = order, res, cost
    bw.write(0b001000 | best_order, 6)
    write_wasted()
    for v in eff[:best_order]:
        bw.write_signed(int(v), eff_bps)
    _write_residual(bw, best_res, len(eff), best_order, partition_order, rice2, force_escape)


def encode(
    data: np.ndarray,
    sample_rate: int,
    block_size: int = 4096,
    mode: str = "fixed",  # fixed | verbatim | constant | lpc
    partition_order: int = 0,
    rice2: bool = False,
    force_escape: bool = False,
    wasted_bits: int = 0,
    stereo_mode: str = "independent",  # independent | left_side
) -> bytes:
    """Encode int16 (n,) mono or (n, 2) stereo PCM to a FLAC stream."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        raise ValueError("encoder expects int16 PCM")
    if data.ndim == 1:
        channels = 1
        n = len(data)
    else:
        channels = data.shape[1]
        n = data.shape[0]
        if channels != 2:
            raise ValueError("only mono or stereo supported")
    bps = 16

    out = bytearray(b"fLaC")
    # STREAMINFO (type 0, last-metadata flag set), 34 bytes.
    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    md5 = hashlib.md5(
        data.astype("<i2").tobytes()
    ).digest()
    for b in md5:
        si.write(b, 8)
    si_bytes = si.bytes()
    out += bytes([0x80 | 0x00]) + len(si_bytes).to_bytes(3, "big") + si_bytes

    frame_idx = 0
    pos = 0
    while pos < n:
        bs = min(block_size, n - pos)
        hw = BitWriter()
        hw.write(0b11111111111110, 14)
        hw.write(0, 1)  # reserved
        hw.write(0, 1)  # fixed blocksize stream
        hw.write(0b0111, 4)  # blocksize: 16-bit value-1 at header end
        if sample_rate == 16000:
            hw.write(0b0101, 4)
        elif sample_rate == 8000:
            hw.write(0b0100, 4)
        elif sample_rate < 65536:
            hw.write(0b1101, 4)
        else:
            hw.write(0b0000, 4)
        if channels == 1:
            ch_code = 0
        elif stereo_mode == "left_side":
            ch_code = 8
        else:
            ch_code = 1
        hw.write(ch_code, 4)
        hw.write(0b100, 3)  # 16 bps
        hw.write(0, 1)  # reserved
        for b in utf8_number(frame_idx):
            hw.write(b, 8)
        hw.write(bs - 1, 16)
        if sample_rate not in (16000, 8000) and sample_rate < 65536:
            hw.write(sample_rate, 16)
        header = hw.bytes()
        header += bytes([crc8(header)])

        fw = BitWriter()
        if channels == 1:
            _encode_subframe(fw, data[pos : pos + bs], bps, mode,
                             partition_order, rice2, force_escape, wasted_bits)
        else:
            L = data[pos : pos + bs, 0].astype(np.int64)
            R = data[pos : pos + bs, 1].astype(np.int64)
            if ch_code == 8:  # left/side
                _encode_subframe(fw, L, bps, mode, partition_order, rice2,
                                 force_escape, wasted_bits)
                _encode_subframe(fw, L - R, bps + 1, mode, partition_order,
                                 rice2, force_escape, wasted_bits)
            else:
                _encode_subframe(fw, L, bps, mode, partition_order, rice2,
                                 force_escape, wasted_bits)
                _encode_subframe(fw, R, bps, mode, partition_order, rice2,
                                 force_escape, wasted_bits)
        fw.align()
        frame = header + fw.bytes()
        frame += crc16(frame).to_bytes(2, "big")
        out += frame
        pos += bs
        frame_idx += 1
    return bytes(out)


def encode_file(path: str, data: np.ndarray, sample_rate: int, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode(data, sample_rate, **kw))
