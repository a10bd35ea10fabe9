"""JPEG Lossless (ITU-T T.81 process 14, SOF3) codec.

Counterpart of ``spine_vision_tpu/io/jpeg_lossless.py``, for the DICOM
transfer syntaxes 1.2.840.10008.1.2.4.57 (Process 14) and .70 (Process 14,
Selection Value 1): predictors 1-7, several components, restart intervals
(prediction resets at each, T.81 H.2.2) and the check that an interval's
padding bits are 1s.

The entropy decode runs in C++ (``native/src/host_ops.cpp``, compiled with
g++ at first use; a failed build raises). ``_split_restart_intervals`` and
``_decode_diffs`` are its plain Python version, which the tests hold it to
bit for bit. Reconstruction is numpy: cumulative sums for predictors 1 and
2, a per-sample loop for 3-7.

``encode_jpeg_lossless`` writes single-component scans with any predictor
and no restart markers, byte for byte as the JAX package's encoder, but
vectorized over the samples.
"""

from __future__ import annotations

import struct

import numpy as np

from spine_vision_torch import native

# Marker bytes (second byte after 0xFF).
_SOI = 0xD8
_EOI = 0xD9
_SOS = 0xDA
_DHT = 0xC4
_SOF3 = 0xC3
_DRI = 0xDD
_RST0, _RST7 = 0xD0, 0xD7


class JpegLosslessError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------


def _build_decode_lut(bits: list[int], values: list[int]) -> np.ndarray:
    """Canonical Huffman table -> 16-bit peek LUT.

    LUT[peek16] = (code_length << 8) | symbol. One array lookup decodes any
    symbol, keeping the per-sample Python work minimal.
    """
    lut = np.zeros(1 << 16, dtype=np.uint16)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            symbol = values[k]
            k += 1
            prefix = code << (16 - length)
            span = 1 << (16 - length)
            lut[prefix : prefix + span] = (length << 8) | symbol
            code += 1
        code <<= 1
    return lut


def _build_encode_table(bits: list[int], values: list[int]) -> dict[int, tuple[int, int]]:
    """Canonical Huffman table -> {symbol: (code, length)}."""
    table: dict[int, tuple[int, int]] = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[values[k]] = (code, length)
            k += 1
            code += 1
        code <<= 1
    return table


# A fixed table covering all 17 difference categories (0..16), used by the
# encoder; decoders always read tables from the DHT segment. Kraft-exact:
# 3 codes of length 2, one each of lengths 3..14, two of length 15.
_ENC_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 0]
_ENC_VALUES = list(range(17))
assert sum(_ENC_BITS) == 17


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class _Frame:
    precision: int
    rows: int
    cols: int
    ncomp: int
    comp_ids: list[int]


def _parse_markers(data: bytes):
    """Walk the marker stream; return (frame, scans).

    Each scan is (comp_selectors, dc_table_ids, psv, al, entropy_bytes).
    """
    if data[:2] != b"\xff\xd8":
        raise JpegLosslessError("Missing SOI")
    pos = 2
    tables: dict[int, np.ndarray] = {}
    frame: _Frame | None = None
    restart_interval = 0
    scans = []
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            raise JpegLosslessError(f"Expected marker at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == _EOI:
            break
        length = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2 : pos + length]
        if marker == _SOF3:
            frame = _Frame()
            frame.precision = seg[0]
            frame.rows, frame.cols = struct.unpack_from(">HH", seg, 1)
            frame.ncomp = seg[5]
            frame.comp_ids = [seg[6 + 3 * i] for i in range(frame.ncomp)]
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise JpegLosslessError(
                f"Not a lossless (SOF3) JPEG: SOF marker 0x{marker:02x}"
            )
        elif marker == _DHT:
            off = 0
            while off < len(seg):
                tc_th = seg[off]
                bits = list(seg[off + 1 : off + 17])
                nval = sum(bits)
                values = list(seg[off + 17 : off + 17 + nval])
                tables[tc_th & 0x0F] = _build_decode_lut(bits, values)
                off += 17 + nval
        elif marker == _DRI:
            restart_interval = struct.unpack_from(">H", seg, 0)[0]
        elif marker == _SOS:
            ns = seg[0]
            selectors = [seg[1 + 2 * i] for i in range(ns)]
            table_ids = [seg[2 + 2 * i] >> 4 for i in range(ns)]
            psv = seg[1 + 2 * ns]  # Ss = predictor selection value
            al = seg[3 + 2 * ns] & 0x0F  # point transform
            # Entropy-coded data runs to the next non-RST marker
            # (vectorized: the per-byte Python scan cost ~120 ms/slice).
            start = pos + length
            arr = np.frombuffer(data, dtype=np.uint8)
            ff = np.flatnonzero(arr[start : n - 1] == 0xFF)
            nxt = arr[start + 1 :][ff]
            real = ff[(nxt != 0x00) & ((nxt < _RST0) | (nxt > _RST7))]
            ep = start + int(real[0]) if real.size else max(start, n - 1)
            scans.append(
                (selectors, table_ids, psv, al, data[pos + length : ep],
                 [tables[t] for t in table_ids], restart_interval)
            )
            pos = ep
            continue
        pos += length
    if frame is None or not scans:
        raise JpegLosslessError("Missing SOF3/SOS")
    return frame, scans


def _split_restart_intervals(entropy: bytes) -> list[bytes]:
    """Split entropy data at RSTn markers, unstuffing 0xFF00 within each."""
    intervals: list[bytes] = []
    cur = bytearray()
    i = 0
    n = len(entropy)
    while i < n:
        b = entropy[i]
        if b == 0xFF and i + 1 < n:
            nxt = entropy[i + 1]
            if nxt == 0x00:
                cur.append(0xFF)
                i += 2
                continue
            if _RST0 <= nxt <= _RST7:
                intervals.append(bytes(cur))
                cur = bytearray()
                i += 2
                continue
        cur.append(b)
        i += 1
    intervals.append(bytes(cur))
    return intervals


def _decode_diffs(
    chunks: list[bytes],
    luts: list[np.ndarray],
    counts_per_interval: int,
    total: int,
    ncomp: int,
) -> np.ndarray:
    """Sequential entropy decode of all difference values.

    Returns int32 [total, ncomp] (component-interleaved MCU order).
    """
    out = np.empty((total, ncomp), dtype=np.int32)
    mcu = 0
    for chunk in chunks:
        if mcu >= total:
            break
        bits = np.unpackbits(np.frombuffer(chunk, dtype=np.uint8))
        # Pad so 16-bit peeks never run off the end.
        bits = np.concatenate([bits, np.ones(32, dtype=np.uint8)])
        weights = 1 << np.arange(15, -1, -1)
        limit = total if counts_per_interval == 0 else min(
            total, mcu + counts_per_interval
        )
        p = 0
        nbits = len(bits) - 32
        while mcu < limit and p < nbits:
            for c in range(ncomp):
                peek = int(bits[p : p + 16] @ weights)
                entry = int(luts[c][peek])
                length = entry >> 8
                if length == 0:
                    raise JpegLosslessError("Invalid Huffman code")
                ssss = entry & 0xFF
                p += length
                if ssss == 0:
                    diff = 0
                elif ssss == 16:
                    diff = 32768
                else:
                    mag = int(bits[p : p + ssss] @ weights[16 - ssss :])
                    p += ssss
                    diff = mag if mag >= (1 << (ssss - 1)) else mag - (1 << ssss) + 1
                out[mcu, c] = diff
            mcu += 1
        # A completed restart interval must end cleanly: fewer than 8
        # unread bits, all 1s (T.81 byte-align padding). Otherwise the
        # stream is corrupt and the tail pixels would be silent garbage.
        if mcu == limit and (
            p > nbits
            or nbits - p >= 8
            or (p < nbits and not bits[p:nbits].all())
        ):
            raise JpegLosslessError("Corrupt entropy tail")
    if mcu < total:
        raise JpegLosslessError(f"Truncated scan: {mcu}/{total} samples")
    return out


def _reconstruct(
    diffs: np.ndarray, rows: int, cols: int, psv: int, precision: int, al: int
) -> np.ndarray:
    """Prediction + modulo-2^16 reconstruction for one component."""
    d = diffs.reshape(rows, cols).astype(np.int64)
    default = 1 << (precision - 1 - al)
    out = np.empty((rows, cols), dtype=np.int64)
    if psv == 1:
        # SV1 (TS .70): Px = Ra; first column predicts from Rb — every row
        # is a cumulative sum seeded by a vertical cumulative first column.
        first_col = (default + np.cumsum(d[:, 0])) % 65536
        out = (np.cumsum(d, axis=1) - d[:, :1] + first_col[:, None]) % 65536
    elif psv == 2:
        # Px = Rb; row 0 predicts from Ra.
        row0 = (default + np.cumsum(d[0])) % 65536
        out = (np.cumsum(d, axis=0) - d[:1, :] + row0[None, :]) % 65536
    else:
        for r in range(rows):
            for c in range(cols):
                if r == 0 and c == 0:
                    px = default
                elif r == 0:
                    px = out[0, c - 1]
                elif c == 0:
                    px = out[r - 1, 0]
                else:
                    a, b, cc = out[r, c - 1], out[r - 1, c], out[r - 1, c - 1]
                    if psv == 3:
                        px = cc
                    elif psv == 4:
                        px = a + b - cc
                    elif psv == 5:
                        px = a + ((b - cc) >> 1)
                    elif psv == 6:
                        px = b + ((a - cc) >> 1)
                    elif psv == 7:
                        px = (a + b) >> 1
                    else:
                        raise JpegLosslessError(f"Bad predictor {psv}")
                out[r, c] = (px + d[r, c]) % 65536
    return (out << al).astype(np.uint16)


def decode_jpeg_lossless(data: bytes) -> np.ndarray:
    """Decode an SOF3 lossless JPEG stream.

    Returns uint16 [rows, cols] (single component) or [rows, cols, ncomp].
    """
    frame, scans = _parse_markers(data)
    rows, cols = frame.rows, frame.cols
    planes: dict[int, np.ndarray] = {}
    for selectors, _tids, psv, al, entropy, luts, ri in scans:
        ncomp = len(selectors)
        try:
            diffs = native.jpegls_decode_diffs(
                *native.jpegls_unstuff_split(entropy), luts, ri, rows * cols, ncomp
            )
        except ValueError as exc:
            raise JpegLosslessError(str(exc)) from exc
        for ci, sel in enumerate(selectors):
            comp = diffs[:, ci]
            if ri and ri < rows * cols:
                # T.81 H.2.2: prediction resets at every restart interval —
                # each interval decodes like a fresh scan. Clinical encoders
                # emit row-aligned intervals; reject anything else loudly
                # rather than reconstruct garbage.
                if ri % cols != 0:
                    raise JpegLosslessError(
                        f"Restart interval {ri} not a multiple of row "
                        f"width {cols}; unsupported"
                    )
                slab = ri // cols
                planes[sel] = np.concatenate(
                    [
                        _reconstruct(
                            comp[r0 * cols : min(r0 + slab, rows) * cols],
                            min(slab, rows - r0),
                            cols,
                            psv,
                            frame.precision,
                            al,
                        )
                        for r0 in range(0, rows, slab)
                    ],
                    axis=0,
                )
            else:
                planes[sel] = _reconstruct(
                    comp, rows, cols, psv, frame.precision, al
                )
    ordered = [planes[cid] for cid in frame.comp_ids if cid in planes]
    if len(ordered) != frame.ncomp:
        raise JpegLosslessError("Missing component scan")
    if frame.ncomp == 1:
        return ordered[0]
    return np.stack(ordered, axis=-1)


# ---------------------------------------------------------------------------
# Encoder (single component, any predictor, no restart markers)
# ---------------------------------------------------------------------------


def _predictions(image: np.ndarray, psv: int, default: int) -> np.ndarray:
    """Each sample's prediction (T.81 H.1.2.1) from its original neighbours,
    which equal the decoder's reconstruction in a lossless scan."""
    img = image.astype(np.int64)
    px = np.empty_like(img)
    px[0, 0] = default
    px[0, 1:] = img[0, :-1]  # first row: Ra
    px[1:, 0] = img[:-1, 0]  # first column: Rb
    a, b, c = img[1:, :-1], img[:-1, 1:], img[:-1, :-1]
    inner = {1: lambda: a, 2: lambda: b, 3: lambda: c, 4: lambda: a + b - c,
             5: lambda: a + ((b - c) >> 1), 6: lambda: b + ((a - c) >> 1),
             7: lambda: (a + b) >> 1}
    if psv not in inner:
        raise JpegLosslessError(f"Bad predictor {psv}")
    px[1:, 1:] = inner[psv]()
    return px


def _entropy_bits(image: np.ndarray, psv: int, precision: int) -> bytes:
    """The scan's entropy-coded bytes: per sample the category's code and
    the difference's SSSS magnitude bits (F.1.2.2.1; none for SSSS 16),
    padded with 1s to a byte and 0xFF-stuffed (F.1.2.3)."""
    default = 1 << (precision - 1)
    diff = (image.astype(np.int64) - _predictions(image, psv, default)) % 65536
    diff = np.where(diff >= 32768, diff - 65536, diff).reshape(-1)
    mag = np.abs(diff)
    ssss = np.zeros(diff.shape, np.int64)
    for k in range(16):
        ssss += (mag >> k) > 0
    ssss[diff == -32768] = 16
    enc = _build_encode_table(_ENC_BITS, _ENC_VALUES)
    codes = np.array([enc[k][0] for k in range(17)], np.int64)[ssss]
    code_len = np.array([enc[k][1] for k in range(17)], np.int64)[ssss]
    extra_len = np.where(ssss == 16, 0, ssss)
    extra = np.where(diff >= 0, diff, diff + (1 << extra_len) - 1) & ((1 << extra_len) - 1)
    word = (codes << extra_len) | extra
    length = code_len + extra_len
    ends = np.cumsum(length)
    total = int(ends[-1]) if ends.size else 0
    owner = np.repeat(np.arange(length.size), length)
    shift = ends[owner] - 1 - np.arange(total)
    bits = ((word[owner] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def encode_jpeg_lossless(
    image: np.ndarray, precision: int = 16, psv: int = 1
) -> bytes:
    """Encode uint16 [rows, cols] as an SOF3 lossless JPEG with one
    component, predictor ``psv`` and the fixed table ``_ENC_BITS``."""
    image = np.asarray(image, dtype=np.uint16)
    rows, cols = image.shape
    entropy = _entropy_bits(image, psv, precision)

    parts = [b"\xff\xd8"]
    # DHT
    dht = bytes([0x00]) + bytes(_ENC_BITS) + bytes(_ENC_VALUES)
    parts.append(b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht)
    # SOF3: precision, rows, cols, 1 component (id 1, sampling 0x11, qt 0)
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    parts.append(b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof)
    # SOS: 1 component, selector 1, DC table 0; Ss=psv, Se=0, AhAl=0
    sos = bytes([1, 1, 0x00, psv, 0, 0x00])
    parts.append(b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos)
    parts.append(entropy)
    parts.append(b"\xff\xd9")
    return b"".join(parts)
