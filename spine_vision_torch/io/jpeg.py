"""JPEG decoder (ITU-T T.81 sequential and progressive DCT, Huffman coded).

The port's counterpart of what the JAX package gets from Pillow (12.1.0, on
libjpeg-turbo): :func:`decode_jpeg` is ``np.asarray(Image.open(f))`` and
:func:`to_mode` its ``.convert("L")`` or ``.convert("RGB")``, bit for bit:

- SOF0 and SOF1 frames at 8-bit precision with 1 or 3 components, sampling
  factors of 1 or 2 in either direction (4:4:4, 4:2:2, 4:2:0, 4:4:0);
  interleaved and single-component scans; DQT at 8 and 16 bits, DHT, DRI and
  RSTn; APPn and COM segments skipped, Adobe APP14's transform flag and the
  JFIF APP0 marker read to choose the colour space as libjpeg's
  ``default_decompress_parms`` does.
- Progressive frames (SOF2): DC first and refinement scans (interleaved or
  not), AC first and refinement scans with their EOB runs and correction
  bits, restart intervals inside progressive scans. The scans decode into
  the coefficient buffers a sequential frame fills; the same inverse DCT,
  upsampling and colour conversion follow. libjpeg-turbo smooths blocks
  (``jdcoefct.c``, ``smoothing_ok``) only while some of the first AC
  coefficients' bits are missing; a complete file has them all, so nothing
  is smoothed, and a file cut short raises as Pillow's load does.
- The entropy decode runs in C++ (``native/src/host_ops.cpp``, built with
  g++ at first use; a failed build raises). :func:`_decode_scan` and
  :func:`_decode_progressive` are its plain Python versions, which the
  tests hold it to bit for bit.
- libjpeg-turbo's arithmetic after it, vectorised in numpy: the islow
  inverse DCT with its range limit (``jidctint.c``), fancy (triangle)
  upsampling of h2v1, h1v2 and h2v2 components (``jdsample.c``; pixel
  replication for an h2 component no more than 2 samples wide, as there),
  and YCbCr to RGB with ``jdcolor.c``'s fixed-point tables.
- :func:`to_mode`: Pillow's ``convert("L")`` of RGB (``Convert.c``'s
  ``L24``: ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``) and
  ``convert("RGB")`` of gray (replication).

Lossless (SOF3: ``io/jpeg_lossless.py``), hierarchical and
arithmetic-coded frames, 12-bit precision and components other than 1 or 3
(CMYK) raise ``NotImplementedError`` naming ROADMAP Queue 1 item 13
before any pixel is decoded. A malformed or truncated stream raises
:class:`JpegError`, an ``OSError`` as Pillow's is.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from spine_vision_torch import native
from spine_vision_torch.io.jpeg_lossless import _build_decode_lut, _split_restart_intervals

UNSUPPORTED = "ROADMAP.md, Queue 1 item 13"

_SOF_BASELINE = (0xC0, 0xC1)
_SOF_PROGRESSIVE = 0xC2
_SOF_OTHER = {
    0xC3: "lossless JPEG (SOF3; io/jpeg_lossless.py decodes it)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded JPEG (SOF10)", 0xCB: "arithmetic-coded JPEG (SOF11)",
    0xCC: "arithmetic-coded JPEG (DAC)", 0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
}
_DHT, _DQT, _DRI, _SOS, _EOI = 0xC4, 0xDB, 0xDD, 0xDA, 0xD9
_APP0, _APP14 = 0xE0, 0xEE

# Zigzag index -> natural (row-major) index of an 8x8 block (T.81 Figure 5).
_NATURAL = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
     12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
     35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
     58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int64)


class JpegError(OSError):
    """A JPEG stream this decoder cannot read: malformed or truncated."""


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not decoded by the port yet: {UNSUPPORTED}")


def is_jpeg(data: bytes) -> bool:
    """Whether ``data`` starts as a JPEG stream does (Pillow's test)."""
    return data[:3] == b"\xff\xd8\xff"


# ---------------------------------------------------------------------------
# The islow inverse DCT (jidctint.c), shared with data/phenikaa/raster.py
# ---------------------------------------------------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
_FIX_0_298631336, _FIX_0_390180644, _FIX_0_541196100 = 2446, 3196, 4433
_FIX_0_765366865, _FIX_0_899976223, _FIX_1_175875602 = 6270, 7373, 9633
_FIX_1_501321110, _FIX_1_847759065, _FIX_1_961570560 = 12299, 15137, 16069
_FIX_2_053119869, _FIX_2_562915447, _FIX_3_072711026 = 16819, 20995, 25172

# libjpeg's post-IDCT range limit, indexed by the low 10 bits.
_RANGE_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                               np.arange(0, 128)]).astype(np.uint8)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d: list, shift: int) -> list:
    """One pass of jpeg_idct_islow over the 8 entries ``d[0..7]``."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _FIX_0_541196100
    tmp2 = z1 - z3 * _FIX_1_847759065
    tmp3 = z1 + z2 * _FIX_0_765366865
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp0, tmp1 = tmp0 * _FIX_0_298631336, tmp1 * _FIX_2_053119869
    tmp2, tmp3 = tmp2 * _FIX_3_072711026, tmp3 * _FIX_1_501321110
    z1, z2 = z1 * -_FIX_0_899976223, z2 * -_FIX_2_562915447
    z3, z4 = z3 * -_FIX_1_961570560 + z5, z4 * -_FIX_0_390180644 + z5
    tmp0, tmp1 = tmp0 + z1 + z3, tmp1 + z2 + z4
    tmp2, tmp3 = tmp2 + z2 + z3, tmp3 + z1 + z4
    return [
        _descale(tmp10 + tmp3, shift), _descale(tmp11 + tmp2, shift),
        _descale(tmp12 + tmp1, shift), _descale(tmp13 + tmp0, shift),
        _descale(tmp13 - tmp0, shift), _descale(tmp12 - tmp1, shift),
        _descale(tmp11 - tmp2, shift), _descale(tmp10 - tmp3, shift),
    ]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """libjpeg's islow inverse DCT of dequantized int64 blocks ``[..., 8, 8]``
    (natural order): the columns, then the rows, then the range limit; uint8
    samples ``[..., 8, 8]``."""
    cols = _idct_1d([coef[..., i, :] for i in range(8)], _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, -2)
    rows = _idct_1d([ws[..., i] for i in range(8)], _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[np.stack(rows, -1) & 1023]


# ---------------------------------------------------------------------------
# Entropy decode: the plain Python version of native.jpeg_decode_scan
# ---------------------------------------------------------------------------


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_scan(
    chunks: list[bytes], luts: np.ndarray, block_comp: np.ndarray,
    restart_interval: int, n_mcus: int,
) -> np.ndarray:
    """Entropy-decode one baseline scan from its unstuffed restart-interval
    chunks, as ``native.jpeg_decode_scan`` does: int16 ``[n_mcus *
    blocks_per_mcu, 64]`` quantized coefficients in natural order. Bits past
    a chunk's end read as 1s; a chunk's codes may not run past it."""
    bpm = len(block_comp)
    out = np.zeros((n_mcus * bpm, 64), np.int16)
    weights = 1 << np.arange(15, -1, -1)
    mcu = 0
    for chunk in chunks:
        if mcu >= n_mcus:
            break
        bits = np.unpackbits(np.frombuffer(chunk, dtype=np.uint8))
        nbits = len(bits)
        # Enough 1s that a block's every peek stays inside the array.
        bits = np.concatenate([bits, np.ones(64 * 32 + 16, np.uint8)])

        def peek(p: int, n: int) -> int:
            return int(bits[p:p + n] @ weights[16 - n:])

        pred = [0] * 4
        limit = n_mcus if restart_interval == 0 else min(n_mcus, mcu + restart_interval)
        p = 0
        while mcu < limit:
            for b, comp in enumerate(block_comp):
                blk = out[mcu * bpm + b]
                entry = int(luts[2 * comp][peek(p, 16)])
                if entry >> 8 == 0 or entry & 0xFF > 16:
                    raise ValueError("Invalid Huffman code")
                p += entry >> 8
                s = entry & 0xFF
                if s:
                    pred[comp] += _extend(peek(p, s), s)
                    p += s
                blk[0] = pred[comp]
                k = 1
                while k < 64:
                    entry = int(luts[2 * comp + 1][peek(p, 16)])
                    if entry >> 8 == 0:
                        raise ValueError("Invalid Huffman code")
                    p += entry >> 8
                    r, s = (entry >> 4) & 15, entry & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("Coefficient run past the end of a block")
                        blk[_NATURAL[k]] = _extend(peek(p, s), s)
                        p += s
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
                if p > nbits:
                    raise ValueError(f"Truncated scan: {mcu}/{n_mcus} MCUs")
            mcu += 1
    if mcu < n_mcus:
        raise ValueError(f"Truncated scan: {mcu}/{n_mcus} MCUs")
    return out


def _wrap16(v: int) -> int:
    """``(JCOEF) v``: the low 16 bits, signed."""
    return ((v + 32768) & 0xFFFF) - 32768


def _decode_progressive(
    chunks: list[bytes], luts: np.ndarray, block_comp: np.ndarray,
    restart_interval: int, n_mcus: int, ss: int, se: int, ah: int, al: int,
    blocks: np.ndarray,
) -> np.ndarray:
    """Entropy-decode one progressive scan into ``blocks`` (int16 ``[n_mcus *
    blocks_per_mcu, 64]``, natural order, the coefficients so far) as
    ``native.jpeg_decode_progressive`` does, following libjpeg's
    ``jdphuff.c``: DC first (``Ss = 0, Ah = 0``) and refinement, AC first
    and refinement with their EOB runs. The DC predictions and the EOB run
    reset at each restart interval. Bits past a chunk's end read as 1s; a
    chunk's codes may not run past it."""
    bpm = len(block_comp)
    weights = 1 << np.arange(15, -1, -1)
    p1, m1 = 1 << al, -(1 << al)
    mcu = 0
    for chunk in chunks:
        if mcu >= n_mcus:
            break
        bits = np.unpackbits(np.frombuffer(chunk, dtype=np.uint8))
        nbits = len(bits)
        bits = np.concatenate([bits, np.ones(64 * 32 + 16, np.uint8)])

        def peek(p: int, n: int) -> int:
            return int(bits[p:p + n] @ weights[16 - n:]) if n else 0

        def symbol(p: int, table: np.ndarray) -> tuple[int, int]:
            entry = int(table[peek(p, 16)])
            if entry >> 8 == 0:
                raise ValueError("Invalid Huffman code")
            return p + (entry >> 8), entry & 0xFF

        pred = [0] * 4
        eobrun = 0
        limit = n_mcus if restart_interval == 0 else min(n_mcus, mcu + restart_interval)
        p = 0
        while mcu < limit:
            for b, comp in enumerate(block_comp):
                blk = blocks[mcu * bpm + b]
                if ss == 0 and ah == 0:  # DC first
                    p, s = symbol(p, luts[2 * comp])
                    if s > 16:
                        raise ValueError("Invalid Huffman code")
                    if s:
                        pred[comp] += _extend(peek(p, s), s)
                        p += s
                    blk[0] = _wrap16(pred[comp] << al)
                elif ss == 0:  # DC refinement
                    if peek(p, 1):
                        blk[0] |= p1
                    p += 1
                elif ah == 0:  # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        p, rs = symbol(p, luts[2 * comp + 1])
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > 63:
                                raise ValueError("Coefficient run past the end of a block")
                            blk[_NATURAL[k]] = _wrap16(_extend(peek(p, s), s) << al)
                            p += s
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + peek(p, r) - 1
                            p += r
                            break
                        k += 1
                else:  # AC refinement
                    k = ss
                    if eobrun == 0:
                        while k <= se:
                            p, rs = symbol(p, luts[2 * comp + 1])
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if peek(p, 1) else m1
                                p += 1
                            elif r != 15:
                                eobrun = (1 << r) + peek(p, r)
                                p += r
                                break
                            while k <= se:
                                z = _NATURAL[k]
                                if blk[z]:
                                    if peek(p, 1) and not blk[z] & p1:
                                        blk[z] += p1 if blk[z] >= 0 else m1
                                    p += 1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                if k > 63:
                                    raise ValueError("Coefficient run past the end of a block")
                                blk[_NATURAL[k]] = s
                            k += 1
                    if eobrun > 0:
                        for k in range(k, se + 1):
                            z = _NATURAL[k]
                            if blk[z]:
                                if peek(p, 1) and not blk[z] & p1:
                                    blk[z] += p1 if blk[z] >= 0 else m1
                                p += 1
                        eobrun -= 1
                if p > nbits:
                    raise ValueError(f"Truncated scan: {mcu}/{n_mcus} MCUs")
            mcu += 1
    if mcu < n_mcus:
        raise ValueError(f"Truncated scan: {mcu}/{n_mcus} MCUs")
    return blocks


# ---------------------------------------------------------------------------
# Markers
# ---------------------------------------------------------------------------


@dataclass
class _Component:
    cid: int
    h: int
    v: int
    tq: int
    coef: np.ndarray | None = None  # int16 [block rows, block cols, 64]


@dataclass
class _Frame:
    height: int
    width: int
    comps: list[_Component]
    progressive: bool = False

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.comps)

    def size(self, c: _Component) -> tuple[int, int]:
        """The component's (downsampled_height, downsampled_width)."""
        return -(-self.height * c.v // self.vmax), -(-self.width * c.h // self.hmax)


def _parse_frame(seg: bytes, progressive: bool) -> _Frame:
    if len(seg) < 6:
        raise JpegError("Truncated SOF segment")
    precision, height, width, ncomp = seg[0], *struct.unpack_from(">HH", seg, 1), seg[5]
    if precision != 8:
        raise _unsupported(f"{precision}-bit JPEG")
    if ncomp not in (1, 3):
        raise _unsupported(f"{ncomp}-component JPEG{' (CMYK)' if ncomp == 4 else ''}")
    if height == 0:
        raise _unsupported("a JPEG whose height is in a DNL marker")
    if width == 0 or len(seg) < 6 + 3 * ncomp:
        raise JpegError("Malformed SOF segment")
    comps = []
    for i in range(ncomp):
        cid, hv, tq = seg[6 + 3 * i: 9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 2 and 1 <= v <= 2):
            raise _unsupported(f"JPEG sampling factors {h}x{v}")
        comps.append(_Component(cid, h, v, tq))
    frame = _Frame(height, width, comps, progressive)
    mcuy = -(-height // (8 * frame.vmax))
    mcux = -(-width // (8 * frame.hmax))
    for c in comps:
        c.coef = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int16)
    return frame


def _scan_end(arr: np.ndarray, start: int) -> int:
    """The byte where a scan's entropy-coded data ends: the first 0xFF
    followed by neither 0x00 nor an RSTn."""
    ff = np.flatnonzero(arr[start:-1] == 0xFF)
    nxt = arr[start + 1:][ff]
    real = ff[(nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD7))]
    if not real.size:
        raise JpegError("Truncated JPEG: no marker after the scan data")
    return start + int(real[0])


def _decode_entropy(entropy: bytes, luts: np.ndarray, block_comp: np.ndarray,
                    restart_interval: int, n_mcus: int, plain: bool,
                    progression: tuple | None = None,
                    blocks: np.ndarray | None = None) -> np.ndarray:
    """One scan's blocks: a sequential scan's, or with ``progression``
    (Ss, Se, Ah, Al) a progressive scan's decoded into ``blocks``."""
    try:
        if plain:
            chunks = _split_restart_intervals(entropy)
            if progression is None:
                return _decode_scan(chunks, luts, block_comp, restart_interval, n_mcus)
            return _decode_progressive(chunks, luts, block_comp, restart_interval, n_mcus,
                                       *progression, blocks)
        data, offsets = native.jpegls_unstuff_split(entropy)
        if progression is None:
            return native.jpeg_decode_scan(data, offsets, luts, block_comp, restart_interval,
                                           n_mcus)
        return native.jpeg_decode_progressive(data, offsets, luts, block_comp,
                                              restart_interval, n_mcus, progression, blocks)
    except ValueError as exc:
        raise JpegError(f"Corrupt JPEG data: {exc}") from exc


def _read_scan(frame: _Frame, seg: bytes, entropy: bytes, dc: dict, ac: dict,
               restart_interval: int, plain: bool) -> None:
    """Decode one scan's coefficients into its components' ``coef``."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= len(frame.comps) or len(seg) < 4 + 2 * ns:
        raise JpegError("Malformed SOS segment")
    ss, se, ahal = seg[1 + 2 * ns: 4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if frame.progressive:
        # libjpeg's start_pass_phuff_decoder checks; a DC refinement scan
        # reads no table, an AC scan only its AC table.
        dc_band = ss == 0
        if (se != 0 if dc_band else (ss > se or se > 63 or ns != 1)) \
                or (ah and al != ah - 1) or al > 13:
            raise JpegError(f"Invalid progressive parameters Ss={ss} Se={se} Ah={ah} Al={al}")
        uses_dc, uses_ac = dc_band and ah == 0, not dc_band
        progression = (ss, se, ah, al)
    else:
        if (ss, se, ahal) != (0, 63, 0):
            raise JpegError(f"Not a sequential scan: Ss={ss} Se={se} AhAl={ahal:#x}")
        uses_dc = uses_ac = True
        progression = None
    by_id = {c.cid: c for c in frame.comps}
    comps, luts = [], []
    empty = np.zeros(1 << 16, np.uint16)
    for i in range(ns):
        cs, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cs not in by_id or (uses_dc and (tables >> 4) not in dc) \
                or (uses_ac and (tables & 15) not in ac):
            raise JpegError(f"Scan component {cs}: unknown component or Huffman table")
        comps.append(by_id[cs])
        luts += [dc[tables >> 4] if uses_dc else empty, ac[tables & 15] if uses_ac else empty]
    luts = np.stack(luts)
    if ns == 1:  # one block an MCU, over the component's own block grid
        c = comps[0]
        dh, dw = frame.size(c)
        bh, bw = -(-dh // 8), -(-dw // 8)
        current = (np.ascontiguousarray(c.coef[:bh, :bw]).reshape(bh * bw, 64)
                   if progression else None)
        more = {"progression": progression, "blocks": current} if progression else {}
        blocks = _decode_entropy(entropy, luts, np.zeros(1, np.int32), restart_interval,
                                 bh * bw, plain, **more)
        c.coef[:bh, :bw] = blocks.reshape(bh, bw, 64)
        return
    c0 = comps[0]
    mcuy, mcux = c0.coef.shape[0] // c0.v, c0.coef.shape[1] // c0.h
    block_comp = np.concatenate([np.full(c.h * c.v, i, np.int32) for i, c in enumerate(comps)])
    more = {}
    if progression:  # the MCUs' blocks as they stand, in MCU order
        current = np.concatenate([
            c.coef.reshape(mcuy, c.v, mcux, c.h, 64).transpose(0, 2, 1, 3, 4).reshape(
                mcuy, mcux, c.h * c.v, 64) for c in comps], axis=2).reshape(-1, 64)
        more = {"progression": progression, "blocks": np.ascontiguousarray(current)}
    blocks = _decode_entropy(entropy, luts, block_comp, restart_interval, mcuy * mcux, plain,
                             **more)
    blocks = blocks.reshape(mcuy, mcux, len(block_comp), 64)
    first = 0
    for c in comps:
        part = blocks[:, :, first:first + c.h * c.v].reshape(mcuy, mcux, c.v, c.h, 64)
        c.coef[:] = part.transpose(0, 2, 1, 3, 4).reshape(mcuy * c.v, mcux * c.h, 64)
        first += c.h * c.v


# ---------------------------------------------------------------------------
# Upsampling (jdsample.c) and colour conversion (jdcolor.c)
# ---------------------------------------------------------------------------


def _edges(x: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Each sample's neighbour before and after along ``axis``, the edges
    replicated."""
    n = x.shape[axis]
    before = np.take(x, np.maximum(np.arange(n) - 1, 0), axis=axis)
    after = np.take(x, np.minimum(np.arange(n) + 1, n - 1), axis=axis)
    return before, after


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        *a.shape[:axis], 2 * a.shape[axis], *a.shape[axis + 1:])


def _upsample(x: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Upsample a component plane ``[dh, dw]`` by ``fh`` across and ``fv``
    down as libjpeg-turbo with ``do_fancy_upsampling`` does."""
    if (fh, fv) == (1, 1):
        return x
    dw = x.shape[1]
    x = x.astype(np.int32)
    if fh == 2 and dw <= 2:  # h2v1_upsample / h2v2_upsample: replication
        return np.repeat(np.repeat(x, 2, axis=1), fv, axis=0).astype(np.uint8)
    if fv == 2:
        above, below = _edges(x, 0)
        if fh == 1:  # h1v2_fancy_upsample
            return _interleave((3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2,
                               0).astype(np.uint8)
        # h2v2_fancy_upsample: the column sums of each output row, then across.
        sums = _interleave(3 * x + above, 3 * x + below, 0)
        last, nxt = _edges(sums, 1)
        return _interleave((3 * sums + last + 8) >> 4, (3 * sums + nxt + 7) >> 4,
                           1).astype(np.uint8)
    left, right = _edges(x, 1)  # h2v1_fancy_upsample
    return _interleave((3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2, 1).astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_CHROMA = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _CHROMA + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _CHROMA + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _CHROMA
_CB_G = -_fix(0.34414) * _CHROMA + (1 << 15)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert``."""
    y = y.astype(np.int64)
    rgb = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def decode_jpeg(data: bytes, plain: bool = False, luma: bool = False) -> np.ndarray:
    """Decode a baseline or progressive JPEG stream as Pillow does: uint8 ``[H, W]`` (one
    component) or ``[H, W, 3]`` (RGB). ``plain`` entropy-decodes with the
    Python version instead of the C++ one (the tests' reference). ``luma``
    returns libjpeg's grayscale output instead, as cv2's
    ``IMREAD_GRAYSCALE`` asks for it: the Y plane of a YCbCr image."""
    data = bytes(data)
    if not is_jpeg(data):
        raise JpegError("Not a JPEG stream (no SOI marker)")
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(data)
    pos = 2
    frame: _Frame | None = None
    dc: dict[int, np.ndarray] = {}
    ac: dict[int, np.ndarray] = {}
    qt: dict[int, np.ndarray] = {}
    restart_interval = 0
    jfif, adobe = False, None
    scans = 0
    while True:
        if pos >= n:
            raise JpegError("Truncated JPEG: no EOI marker")
        if data[pos] != 0xFF:
            raise JpegError(f"Expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            raise JpegError("Truncated JPEG: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == _EOI:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # stand-alone markers
            continue
        if pos + 2 > n:
            raise JpegError("Truncated JPEG segment")
        length = struct.unpack_from(">H", data, pos)[0]
        if length < 2 or pos + length > n:
            raise JpegError(f"Truncated JPEG segment (marker 0x{marker:02x})")
        seg = data[pos + 2:pos + length]
        if marker in _SOF_OTHER:
            raise _unsupported(_SOF_OTHER[marker])
        if marker in _SOF_BASELINE or marker == _SOF_PROGRESSIVE:
            frame = _parse_frame(seg, marker == _SOF_PROGRESSIVE)
        elif marker == _DHT:
            off = 0
            while off + 17 <= len(seg):
                tc_th = seg[off]
                bits = list(seg[off + 1:off + 17])
                values = list(seg[off + 17:off + 17 + sum(bits)])
                if len(values) != sum(bits) or (tc_th >> 4) > 1:
                    raise JpegError("Malformed DHT segment")
                (ac if tc_th >> 4 else dc)[tc_th & 15] = _build_decode_lut(bits, values)
                off += 17 + len(values)
        elif marker == _DQT:
            off = 0
            while off < len(seg):
                pq, tq = seg[off] >> 4, seg[off] & 15
                size = 128 if pq else 64
                if off + 1 + size > len(seg):
                    raise JpegError("Malformed DQT segment")
                raw = np.frombuffer(seg[off + 1:off + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_NATURAL] = raw
                qt[tq] = table
                off += 1 + size
        elif marker == _DRI:
            restart_interval = struct.unpack_from(">H", seg, 0)[0]
        elif marker == _APP0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == _APP14 and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == _SOS:
            if frame is None:
                raise JpegError("Scan before the frame header")
            end = _scan_end(arr, pos + length)
            _read_scan(frame, seg, data[pos + length:end], dc, ac, restart_interval, plain)
            scans += 1
            pos = end
            continue
        pos += length
    if frame is None or not scans:
        raise JpegError("No frame or no scan in the JPEG stream")
    planes = []
    for c in frame.comps:
        if c.tq not in qt:
            raise JpegError(f"Component {c.cid}: no quantization table {c.tq}")
        deq = c.coef.astype(np.int64) * qt[c.tq]
        bh, bw = deq.shape[:2]
        pixels = idct_islow(deq.reshape(bh, bw, 8, 8)).transpose(0, 2, 1, 3)
        dh, dw = frame.size(c)
        plane = pixels.reshape(bh * 8, bw * 8)[:dh, :dw]
        up = _upsample(plane, frame.hmax // c.h, frame.vmax // c.v)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    ids = tuple(c.cid for c in frame.comps)
    if jfif:
        rgb_space = False
    elif adobe is not None:
        rgb_space = adobe == 0
    else:
        rgb_space = ids == (82, 71, 66)  # "R", "G", "B"
    if luma:
        if rgb_space:
            raise _unsupported("the grayscale output of an RGB JPEG")
        return np.ascontiguousarray(planes[0])
    if rgb_space:
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)


def to_mode(image: np.ndarray, mode: str) -> np.ndarray:
    """Pillow's ``convert(mode)`` of a decoded JPEG: "L" (RGB by ``L24``,
    gray as it is) or "RGB" (gray replicated, RGB as it is)."""
    img = np.asarray(image, np.uint8)
    if mode == "L":
        if img.ndim == 2:
            return img
        x = img.astype(np.int64)
        return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000)
                >> 16).astype(np.uint8)
    if mode == "RGB":
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=-1)
    raise ValueError(f"Unsupported mode: {mode}")


def read_jpeg(path: str | Path, mode: str | None = None) -> np.ndarray:
    """``np.asarray(Image.open(path))`` of a baseline or progressive JPEG file, converted to
    ``mode`` ("L" or "RGB") when given."""
    image = decode_jpeg(Path(path).read_bytes())
    return image if mode is None else to_mode(image, mode)
