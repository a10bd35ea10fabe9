"""JPEG 2000 decoder (ITU-T T.800, Part 1), as Pillow decodes it.

The port's counterpart of what the JAX package gets from Pillow (12.1.0, on
OpenJPEG 2.5.4) for JPEG 2000: :func:`decode_jpeg2000` is
``np.asarray(Image.open(f))`` of a raw codestream or a JP2 file, bit for bit
for the reversible 5/3 path and in OpenJPEG's float32 order of operations
for the irreversible 9/7 path.

- Codestream: SIZ, COD, COC, QCD, QCC (no, scalar-derived and expounded
  quantization), SOT/SOD/EOC; TLM, PLM, PLT, CRG and COM are skipped. Tiles,
  tile and image offsets, several tile-parts a tile. JP2 files are read for
  their ``ihdr`` and ``colr`` boxes and their ``jp2c`` codestream.
- Tier-2: packet headers with their tag trees (inclusion, zero bit-planes),
  pass counts and Lblock lengths; SOP and EPH markers; the five progression
  orders as OpenJPEG's ``pi.c`` walks them; precincts at every resolution;
  quality layers.
- Tier-1 (the MQ decoder and the three coding passes) runs in C++
  (``native/src/host_ops.cpp``, built with g++ at first use, OpenMP over
  code-blocks; a failed build raises). :func:`_t1_decode_block` is its plain
  Python version, which the tests hold it to on every code-block.
- Dequantization on the decoder's doubled magnitudes, the inverse 5/3
  (integer lifting) and 9/7 (OpenJPEG's lifting constants and scalings,
  rows then columns, in float32) wavelets, RCT and ICT, DC level shift,
  ``lrintf`` rounding and the clamp to the component's range, in numpy.
- Pillow's mode and scaling: one component is ``L`` up to 8 bits and
  ``I;16`` above (a raw codestream's SIZ precision; a JP2's ``ihdr``), each
  sample shifted to the mode's width (a 12-bit frame comes back as
  ``x << 4``) after Pillow's offset of ``2**(prec-1)`` for signed data; 2, 3
  and 4 components are ``LA``, ``RGB`` and ``RGBA``; a JP2 whose ``colr``
  box says sYCC is converted to RGB with Pillow's YCbCr tables.
  :func:`to_rgb` is Pillow's ``convert("RGB")`` of those modes.

What no Pillow-written stream carries raises ``NotImplementedError``
naming ROADMAP Queue 1 item 13 before any pixel is produced: POC, RGN,
PPM/PPT, code-block styles other than 0, sub-sampled components, precisions
above 16, multiple component transforms other than RCT/ICT, and other
markers or JP2 colour spaces. A malformed stream raises
:class:`Jpeg2000Error`, an ``OSError`` as Pillow's is.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
import numpy as np

from spine_vision_torch import native

UNSUPPORTED = "ROADMAP.md, Queue 1 item 13"

CODESTREAM_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \r\n\x87\n"

_COD, _COC, _TLM, _PLM, _PLT = 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58
_QCD, _QCC, _RGN, _POC, _PPM, _PPT, _CRG = 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF63
_COM, _SOT, _SOD, _EOC = 0xFF64, 0xFF90, 0xFF93, 0xFFD9
_SKIPPED = {_TLM, _PLM, _PLT, _CRG, _COM}
_NAMED = {_RGN: "region of interest (RGN)", _POC: "progression order changes (POC)",
          _PPM: "packed packet headers (PPM)", _PPT: "packed packet headers (PPT)"}
_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


class Jpeg2000Error(OSError):
    """A JPEG 2000 stream this decoder cannot read: malformed or truncated."""


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not decoded by the port yet: {UNSUPPORTED}")


def is_jpeg2000(data: bytes) -> bool:
    """Whether ``data`` starts as a raw codestream or a JP2 file does
    (Pillow's test)."""
    return data[:4] == CODESTREAM_MAGIC or data[:12] == JP2_MAGIC


# ---------------------------------------------------------------------------
# Tier-1: the plain Python version of native.j2k_t1_decode
# ---------------------------------------------------------------------------

# The MQ coder's states (T.800 Table C.2): Qe, next state after an MPS, after
# an LPS, and whether an LPS switches the MPS sense.
_MQ_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
          0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
          0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
          0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
          0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_MQ_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23,
            24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44,
            45, 45, 46)
_MQ_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19,
            20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
            41, 42, 43, 46)
_MQ_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32

# Context labels (T.800 D.3): 0-8 zero coding, 9-13 sign, 14-16 magnitude
# refinement, 17 run length, 18 uniform.
_CTX_MAG, _CTX_RL, _CTX_UNI = 14, 17, 18


def _zc_table() -> list:
    """Zero-coding context of each band orientation (0 LL, 1 HL, 2 LH, 3 HH)
    by the significant neighbours: index ``orient * 45 + h * 15 + v * 5 + d``
    (Table D.1; HL swaps the horizontal and vertical counts)."""
    table = []
    for orient in range(4):
        for h in range(3):
            for v in range(3):
                for d in range(5):
                    hh, vv = (v, h) if orient == 1 else (h, v)
                    if orient == 3:
                        hv = hh + vv
                        if d >= 3:
                            ctx = 8
                        elif d == 2:
                            ctx = 7 if hv >= 1 else 6
                        elif d == 1:
                            ctx = 5 if hv >= 2 else 4 if hv == 1 else 3
                        else:
                            ctx = 2 if hv >= 2 else hv
                    elif hh == 2:
                        ctx = 8
                    elif hh == 1:
                        ctx = 7 if vv >= 1 else 6 if d >= 1 else 5
                    elif vv == 2:
                        ctx = 4
                    elif vv == 1:
                        ctx = 3
                    else:
                        ctx = 2 if d >= 2 else d
                    table.append(ctx)
    return table


_ZC = _zc_table()
# Sign coding (Table D.3) by the clamped horizontal and vertical contributions
# (-1, 0, 1): index (hc + 1) * 3 + (vc + 1) -> (context, XOR bit).
_SC = ((13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0), (12, 0), (13, 0))


class _MQDecoder:
    """The MQ decoder (T.800 C.3) over one code-block's bytes, followed by
    OpenJPEG's artificial 0xFF 0xFF marker."""

    def __init__(self, data: bytes) -> None:
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        self.c = (self.buf[0] << 16) if data else 0xFF << 16
        self.ct = 0
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[0], self.state[_CTX_RL], self.state[_CTX_UNI] = 4, 3, 46

    def _bytein(self) -> None:
        # The artificial marker stops ``bp`` at the data's end: ``bp + 1``
        # is always inside the buffer.
        buf, bp = self.buf, self.bp
        nxt = buf[bp + 1]
        if buf[bp] == 0xFF:
            if nxt > 0x8F:
                self.c = (self.c + 0xFF00) & 0xFFFFFFFF
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c = (self.c + (nxt << 9)) & 0xFFFFFFFF
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c = (self.c + (nxt << 8)) & 0xFFFFFFFF
            self.ct = 8

    def decode(self, cx: int) -> int:
        s = self.state[cx]
        qe = _MQ_QE[s]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = self.mps[cx]
                self.state[cx] = _MQ_NMPS[s]
            else:
                d = 1 - self.mps[cx]
                if _MQ_SWITCH[s]:
                    self.mps[cx] = d
                self.state[cx] = _MQ_NLPS[s]
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if _MQ_SWITCH[s]:
                    self.mps[cx] = d
                self.state[cx] = _MQ_NLPS[s]
            else:
                d = self.mps[cx]
                self.state[cx] = _MQ_NMPS[s]
        while True:  # RENORMD
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                return d


def _t1_decode_block(data: bytes, w: int, h: int, orient: int, nbps: int,
                     passes: int) -> np.ndarray:
    """Decode one code-block (code-block style 0) as OpenJPEG's
    ``opj_t1_decode_cblk`` does: int32 ``[h, w]`` in the decoder's doubled
    magnitudes (``2 |q| + 1`` at the reconstruction midpoint, signed).
    ``nbps`` is Mb less the zero bit-planes, ``passes`` the coding passes
    included: cleanup first, then significance, refinement and cleanup of
    each lower bit-plane."""
    out = np.zeros((h, w), np.int32)
    if nbps <= 0 or passes <= 0 or w == 0 or h == 0:
        return out
    mq = _MQDecoder(data)
    W = w + 2  # one guard column each side, one guard row above and below
    sig = [0] * (W * (h + 2))
    neg = [0] * (W * (h + 2))
    pi = [0] * (W * (h + 2))
    mu = [0] * (W * (h + 2))
    val = [0] * (W * (h + 2))
    zc = _ZC[orient * 45:orient * 45 + 45]

    def counts(i: int) -> tuple[int, int, int]:
        return (sig[i - 1] + sig[i + 1], sig[i - W] + sig[i + W],
                sig[i - W - 1] + sig[i - W + 1] + sig[i + W - 1] + sig[i + W + 1])

    def significant(i: int, value: int) -> None:
        hc = (sig[i - 1] * (1 - 2 * neg[i - 1]) + sig[i + 1] * (1 - 2 * neg[i + 1]))
        vc = (sig[i - W] * (1 - 2 * neg[i - W]) + sig[i + W] * (1 - 2 * neg[i + W]))
        ctx, xor = _SC[(max(-1, min(1, hc)) + 1) * 3 + max(-1, min(1, vc)) + 1]
        s = mq.decode(ctx) ^ xor
        sig[i], neg[i], val[i] = 1, s, -value if s else value

    bpno = nbps
    pass_type = 2  # cleanup first
    for _ in range(passes):
        if bpno < 1:
            break
        one = 1 << bpno
        half = one >> 1
        oneplushalf = one | half
        for k in range(0, h, 4):
            for x in range(w):
                y = k
                if pass_type == 2 and k + 4 <= h:
                    i0 = (k + 1) * W + x + 1
                    col = range(i0, i0 + 4 * W, W)
                    if not any(sig[i] or pi[i] or any(counts(i)) for i in col):
                        if not mq.decode(_CTX_RL):
                            for i in col:
                                pi[i] = 0
                            continue
                        run = mq.decode(_CTX_UNI) << 1
                        run |= mq.decode(_CTX_UNI)
                        significant(i0 + run * W, oneplushalf)
                        y = k + run + 1
                for yy in range(y, min(k + 4, h)):
                    i = (yy + 1) * W + x + 1
                    if pass_type == 0:
                        if not sig[i] and not pi[i]:
                            hs, vs, ds = counts(i)
                            if hs or vs or ds:
                                if mq.decode(zc[hs * 15 + vs * 5 + ds]):
                                    significant(i, oneplushalf)
                                pi[i] = 1
                    elif pass_type == 1:
                        if sig[i] and not pi[i]:
                            ctx = _CTX_MAG + 2 if mu[i] else _CTX_MAG + (1 if any(counts(i)) else 0)
                            v = mq.decode(ctx)
                            val[i] += half if v ^ (val[i] < 0) else -half
                            mu[i] = 1
                    else:
                        if not sig[i] and not pi[i]:
                            hs, vs, ds = counts(i)
                            if mq.decode(zc[hs * 15 + vs * 5 + ds]):
                                significant(i, oneplushalf)
                if pass_type == 2:
                    for yy in range(k, min(k + 4, h)):
                        pi[(yy + 1) * W + x + 1] = 0
        pass_type += 1
        if pass_type == 3:
            pass_type = 0
            bpno -= 1
    grid = np.asarray(val, np.int64).reshape(h + 2, W)[1:-1, 1:-1]
    out[:] = grid
    return out


def _t1_decode(data: np.ndarray, blocks: np.ndarray, total: int, plain: bool) -> np.ndarray:
    """Every code-block of a tile: int32 ``[total]`` from ``blocks`` rows
    (data offset, length, w, h, orient, nbps, passes, output offset)."""
    if not plain:
        return native.j2k_t1_decode(data, blocks, total)
    out = np.zeros(total, np.int32)
    raw = data.tobytes()
    for off, length, w, h, orient, nbps, passes, at in blocks.tolist():
        out[at:at + w * h] = _t1_decode_block(raw[off:off + length], w, h, orient, nbps,
                                              passes).ravel()
    return out


# ---------------------------------------------------------------------------
# Main and tile-part headers
# ---------------------------------------------------------------------------


@dataclass
class _Coding:
    """A component's coding style (COD's or COC's SPcod)."""

    levels: int
    cbw: int  # code-block width and height exponents
    cbh: int
    reversible: bool
    precincts: list  # (PPx, PPy) per resolution, lowest first


@dataclass
class _Quant:
    guard: int
    steps: list  # (exponent, mantissa) per band, LL first


@dataclass
class _Siz:
    xsiz: int
    ysiz: int
    x0: int
    y0: int
    tw: int
    th: int
    tx0: int
    ty0: int
    prec: list
    signed: list

    @property
    def ncomp(self) -> int:
        return len(self.prec)


@dataclass
class _Style:
    """The coding style a tile uses: COD's Scod and SGcod, each component's
    SPcod and quantization."""

    sop: bool = False
    eph: bool = False
    progression: int = 0
    layers: int = 1
    mct: int = 0
    coding: list = field(default_factory=list)
    quant: list = field(default_factory=list)

    def copy(self) -> "_Style":
        return _Style(self.sop, self.eph, self.progression, self.layers, self.mct,
                      list(self.coding), list(self.quant))


def _u8(seg: bytes, at: int) -> int:
    if at >= len(seg):
        raise Jpeg2000Error("Truncated JPEG 2000 marker segment")
    return seg[at]


def _parse_siz(seg: bytes) -> _Siz:
    if len(seg) < 36:
        raise Jpeg2000Error("Truncated SIZ segment")
    _, xsiz, ysiz, x0, y0, tw, th, tx0, ty0, ncomp = struct.unpack_from(">HIIIIIIIIH", seg)
    if len(seg) < 36 + 3 * ncomp or ncomp == 0:
        raise Jpeg2000Error("Malformed SIZ segment")
    if x0 >= xsiz or y0 >= ysiz or tw == 0 or th == 0 or tx0 > x0 or ty0 > y0 \
            or tx0 + tw <= x0 or ty0 + th <= y0:
        raise Jpeg2000Error("Malformed SIZ segment: inconsistent image and tile sizes")
    prec, signed = [], []
    for c in range(ncomp):
        ssiz, dx, dy = seg[36 + 3 * c: 39 + 3 * c]
        if dx != 1 or dy != 1:
            raise _unsupported(f"a sub-sampled JPEG 2000 component ({dx}x{dy})")
        if (ssiz & 0x7F) + 1 > 16:
            raise _unsupported(f"{(ssiz & 0x7F) + 1}-bit JPEG 2000 samples")
        prec.append((ssiz & 0x7F) + 1)
        signed.append(bool(ssiz & 0x80))
    return _Siz(xsiz, ysiz, x0, y0, tw, th, tx0, ty0, prec, signed)


def _parse_spcod(seg: bytes, at: int, with_precincts: bool) -> _Coding:
    levels, xcb, ycb, style, transform = (_u8(seg, at + i) for i in range(5))
    if levels > 32:
        raise Jpeg2000Error(f"{levels} decomposition levels")
    if not (2 <= xcb + 2 <= 10 and 2 <= ycb + 2 <= 10 and xcb + ycb + 4 <= 12):
        raise Jpeg2000Error(f"Code-block size 2^{xcb + 2} x 2^{ycb + 2}")
    if style:
        raise _unsupported(f"JPEG 2000 code-block style {style:#04x}")
    if transform > 1:
        raise _unsupported(f"JPEG 2000 wavelet transform {transform}")
    if with_precincts:
        pp = [_u8(seg, at + 5 + r) for r in range(levels + 1)]
        precincts = [(p & 15, p >> 4) for p in pp]
        if any((px == 0 or py == 0) and r > 0 for r, (px, py) in enumerate(precincts)):
            raise Jpeg2000Error("A precinct of size 1 above the lowest resolution")
    else:
        precincts = [(15, 15)] * (levels + 1)
    return _Coding(levels, xcb + 2, ycb + 2, transform == 1, precincts)


def _parse_quant(seg: bytes, at: int) -> _Quant:
    sq = _u8(seg, at)
    style, guard = sq & 0x1F, sq >> 5
    body = seg[at + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in body]
    elif style in (1, 2):
        if len(body) < 2 or len(body) % 2:
            raise Jpeg2000Error("Malformed quantization segment")
        steps = [(v >> 11, v & 0x7FF) for v in struct.unpack(f">{len(body) // 2}H", body)]
        if style == 1:  # scalar derived: one step; the others follow from it
            steps = steps[:1] + [None]
    else:
        raise Jpeg2000Error(f"Quantization style {style}")
    if not steps:
        raise Jpeg2000Error("Quantization segment without step sizes")
    return _Quant(guard, steps)


def _component_index(seg: bytes, ncomp: int) -> tuple[int, int]:
    if ncomp < 257:
        return _u8(seg, 0), 1
    if len(seg) < 2:
        raise Jpeg2000Error("Truncated COC/QCC segment")
    return struct.unpack_from(">H", seg)[0], 2


def _apply(marker: int, seg: bytes, style: _Style, siz: _Siz, own: set) -> None:
    """Apply a COD, COC, QCD or QCC segment to ``style``. ``own`` holds the
    components a COC (``("coc", c)``) or QCC (``("qcc", c)``) of this header
    set, which a COD or QCD of the same header does not override."""
    if marker == _COD:
        if len(seg) < 5:
            raise Jpeg2000Error("Truncated COD segment")
        scod, prog = seg[0], seg[1]
        layers, mct = struct.unpack_from(">HB", seg, 2)
        if prog > 4:
            raise Jpeg2000Error(f"Progression order {prog}")
        if layers == 0:
            raise Jpeg2000Error("Zero quality layers")
        if mct > 1:
            raise _unsupported(f"JPEG 2000 multiple component transform {mct}")
        style.sop, style.eph = bool(scod & 2), bool(scod & 4)
        style.progression, style.layers, style.mct = prog, layers, mct
        coding = _parse_spcod(seg, 5, bool(scod & 1))
        for c in range(siz.ncomp):
            if ("coc", c) not in own:
                style.coding[c] = coding
    elif marker == _COC:
        c, n = _component_index(seg, siz.ncomp)
        if c >= siz.ncomp:
            raise Jpeg2000Error(f"COC of component {c}")
        style.coding[c] = _parse_spcod(seg, n + 1, bool(_u8(seg, n) & 1))
        own.add(("coc", c))
    elif marker == _QCD:
        quant = _parse_quant(seg, 0)
        for c in range(siz.ncomp):
            if ("qcc", c) not in own:
                style.quant[c] = quant
    elif marker == _QCC:
        c, n = _component_index(seg, siz.ncomp)
        if c >= siz.ncomp:
            raise Jpeg2000Error(f"QCC of component {c}")
        style.quant[c] = _parse_quant(seg, n)
        own.add(("qcc", c))


def _segments(cs: bytes, pos: int):
    """Yield (marker, segment body, position after it) from ``pos``; stops
    after SOD (body: b"") or at EOC."""
    n = len(cs)
    while True:
        if pos + 2 > n:
            raise Jpeg2000Error("Truncated JPEG 2000 codestream: no EOC marker")
        marker = struct.unpack_from(">H", cs, pos)[0]
        if marker in (_SOD, _EOC):
            yield marker, b"", pos + 2
            return
        if marker >> 8 != 0xFF or pos + 4 > n:
            raise Jpeg2000Error(f"Expected a marker at byte {pos}")
        length = struct.unpack_from(">H", cs, pos + 2)[0]
        if length < 2 or pos + 2 + length > n:
            raise Jpeg2000Error(f"Truncated marker segment {marker:#06x}")
        yield marker, cs[pos + 4:pos + 2 + length], pos + 2 + length
        pos += 2 + length


def _check_marker(marker: int) -> None:
    if marker in _NAMED:
        raise _unsupported(f"JPEG 2000 {_NAMED[marker]}")
    if marker not in (_COD, _COC, _QCD, _QCC) and marker not in _SKIPPED:
        raise _unsupported(f"JPEG 2000 marker {marker:#06x}")


def _parse_codestream(cs: bytes) -> tuple[_Siz, _Style, dict]:
    """The image size, the main header's coding style, and each tile's
    (coding style, concatenated tile-part bodies)."""
    if cs[:4] != CODESTREAM_MAGIC:
        raise Jpeg2000Error("Not a JPEG 2000 codestream (no SOC/SIZ)")
    length = struct.unpack_from(">H", cs, 4)[0] if len(cs) >= 6 else 0
    siz = _parse_siz(cs[6:4 + length])
    main = _Style(coding=[None] * siz.ncomp, quant=[None] * siz.ncomp)
    own: set = set()
    pos = 4 + length
    tiles: dict[int, list] = {}
    n_tiles = (-(-(siz.xsiz - siz.tx0) // siz.tw)) * (-(-(siz.ysiz - siz.ty0) // siz.th))
    seen_cod = seen_qcd = False
    for marker, seg, after in _segments(cs, pos):
        if marker == _SOT:
            pos = after - len(seg) - 4
            break
        if marker in (_SOD, _EOC):
            raise Jpeg2000Error("No tile in the JPEG 2000 codestream")
        _check_marker(marker)
        seen_cod |= marker == _COD
        seen_qcd |= marker == _QCD
        _apply(marker, seg, main, siz, own)
    if not seen_cod or not seen_qcd:
        raise Jpeg2000Error("The main header lacks COD or QCD")
    while True:
        if pos + 2 > len(cs):  # OpenJPEG and Pillow refuse a stream cut short
            raise Jpeg2000Error("Truncated JPEG 2000 codestream: no EOC marker")
        marker = struct.unpack_from(">H", cs, pos)[0]
        if marker == _EOC:
            break
        if marker != _SOT:
            raise Jpeg2000Error(f"Expected SOT at byte {pos}")
        if pos + 12 > len(cs):
            raise Jpeg2000Error("Truncated SOT segment")
        isot, psot, _, _ = struct.unpack_from(">HIBB", cs, pos + 4)
        if isot >= n_tiles:
            raise Jpeg2000Error(f"Tile index {isot} of {n_tiles}")
        end = cs.rfind(b"\xff\xd9") if psot == 0 else pos + psot  # 0: up to EOC
        if end > len(cs) or end < pos + 12:
            raise Jpeg2000Error("Truncated JPEG 2000 tile-part")
        entry = tiles.get(isot)
        if entry is None:
            entry = tiles[isot] = [main.copy(), [], set()]
        body_at = None
        for marker, seg, after in _segments(cs, pos + 12):
            if marker == _SOD:
                body_at = after
                break
            if marker == _EOC:
                raise Jpeg2000Error("EOC inside a tile-part header")
            _check_marker(marker)
            _apply(marker, seg, entry[0], siz, entry[2])
        if body_at is None or body_at > end:
            raise Jpeg2000Error("Malformed tile-part")
        entry[1].append(cs[body_at:end])
        pos = end
    for c in range(siz.ncomp):
        if main.quant[c] is None or main.coding[c] is None:
            raise Jpeg2000Error(f"No coding style for component {c}")
    return siz, main, {t: (e[0], b"".join(e[1])) for t, e in tiles.items()}


# ---------------------------------------------------------------------------
# Tile geometry
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ceil_pow2(a: int, n: int) -> int:
    return -((-a) >> n)


class _TagTree:
    """A tag tree over a ``w x h`` grid of leaves (OpenJPEG's ``opj_tgt``)."""

    def __init__(self, w: int, h: int) -> None:
        self.parent: list[int] = []
        sizes = [(w, h)]
        while sizes[-1] != (1, 1):
            lw, lh = sizes[-1]
            sizes.append(((lw + 1) // 2, (lh + 1) // 2))
        starts = [0]
        for lw, lh in sizes:
            starts.append(starts[-1] + lw * lh)
        for level, (lw, lh) in enumerate(sizes):
            for j in range(lh):
                for i in range(lw):
                    if level + 1 < len(sizes):
                        pw = sizes[level + 1][0]
                        self.parent.append(starts[level + 1] + (j // 2) * pw + i // 2)
                    else:
                        self.parent.append(-1)
        self.value = [999] * len(self.parent)
        self.low = [0] * len(self.parent)

    def decode(self, bio: "_BitReader", leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bio.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return self.value[node] < threshold


@dataclass
class _Block:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    nbps: int = 0
    lblock: int = 3
    passes: int = 0
    chunks: list = field(default_factory=list)


@dataclass
class _Band:
    orient: int  # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    mb: int  # Mb: guard bits + exponent - 1
    step: float  # Delta_b (irreversible)
    precincts: list = field(default_factory=list)  # [(cw, ch, blocks, incl, imsb)]


@dataclass
class _Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    pdx: int
    pdy: int
    pw: int
    ph: int
    bands: list


def _step(quant: _Quant, index: int) -> tuple[int, int]:
    if quant.steps[-1] is None:  # scalar derived (Sqcd style 1), E.1.1.2
        expn, mant = quant.steps[0]
        return max(expn - (index - 1) // 3, 0) if index else expn, mant
    if index >= len(quant.steps):
        raise Jpeg2000Error(f"No quantization step for band {index}")
    return quant.steps[index]


def _resolutions(tile: tuple, coding: _Coding, quant: _Quant, prec: int) -> list:
    tcx0, tcy0, tcx1, tcy1 = tile
    nl = coding.levels
    out = []
    for r in range(nl + 1):
        level = nl - r
        x0, y0 = _ceil_pow2(tcx0, level), _ceil_pow2(tcy0, level)
        x1, y1 = _ceil_pow2(tcx1, level), _ceil_pow2(tcy1, level)
        pdx, pdy = coding.precincts[r]
        pw = 0 if x0 == x1 else _ceil_pow2(x1, pdx) - (x0 >> pdx)
        ph = 0 if y0 == y1 else _ceil_pow2(y1, pdy) - (y0 >> pdy)
        if r == 0:
            cbg_x0, cbg_y0, cbgw, cbgh = (x0 >> pdx) << pdx, (y0 >> pdy) << pdy, pdx, pdy
            orients = (0,)
        else:
            cbg_x0 = _ceil_pow2((x0 >> pdx) << pdx, 1)
            cbg_y0 = _ceil_pow2((y0 >> pdy) << pdy, 1)
            cbgw, cbgh = pdx - 1, pdy - 1
            orients = (1, 2, 3)
        cbw, cbh = min(coding.cbw, cbgw), min(coding.cbh, cbgh)
        bands = []
        for orient in orients:
            if orient == 0:
                bx0, by0 = _ceil_pow2(tcx0, level), _ceil_pow2(tcy0, level)
                bx1, by1 = _ceil_pow2(tcx1, level), _ceil_pow2(tcy1, level)
                index = 0
            else:
                xo, yo = orient & 1, orient >> 1
                n = level + 1
                bx0 = _ceil_pow2(tcx0 - (xo << level), n)
                by0 = _ceil_pow2(tcy0 - (yo << level), n)
                bx1 = _ceil_pow2(tcx1 - (xo << level), n)
                by1 = _ceil_pow2(tcy1 - (yo << level), n)
                index = 3 * (r - 1) + orient
            expn, mant = _step(quant, index)
            mb = expn + quant.guard - 1
            step = np.float32((1.0 + mant / 2048.0) * math.pow(2.0, prec - expn))
            band = _Band(orient, bx0, by0, bx1, by1, mb, step)
            for p in range(pw * ph):
                px0 = cbg_x0 + (p % pw) * (1 << cbgw)
                py0 = cbg_y0 + (p // pw) * (1 << cbgh)
                px0, px1 = max(px0, bx0), min(px0 + (1 << cbgw), bx1)
                py0, py1 = max(py0, by0), min(py0 + (1 << cbgh), by1)
                if px0 >= px1 or py0 >= py1:
                    band.precincts.append((0, 0, [], None, None))
                    continue
                cx0, cy0 = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                cw = (_ceil_pow2(px1, cbw) << cbw) - cx0 >> cbw
                ch = (_ceil_pow2(py1, cbh) << cbh) - cy0 >> cbh
                blocks = []
                for b in range(cw * ch):
                    bx = cx0 + (b % cw) * (1 << cbw)
                    by = cy0 + (b // cw) * (1 << cbh)
                    blocks.append(_Block(max(bx, px0), max(by, py0), min(bx + (1 << cbw), px1),
                                         min(by + (1 << cbh), py1)))
                band.precincts.append((cw, ch, blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
            bands.append(band)
        out.append(_Resolution(x0, y0, x1, y1, pdx, pdy, pw, ph, bands))
    return out


# ---------------------------------------------------------------------------
# Tier-2: packets
# ---------------------------------------------------------------------------


class _BitReader:
    """OpenJPEG's ``opj_bio`` reading a packet header: MSB first, 7 bits of
    the byte after an 0xFF, zeros past the end."""

    def __init__(self, data: bytes, pos: int) -> None:
        self.data, self.pos, self.buf, self.ct = data, pos, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < len(self.data):
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        if (self.buf & 0xFF) == 0xFF:
            self.ct = 0
            self.bit()  # the stuffed byte after an 0xFF
        self.ct = 0
        return self.pos


def _num_passes(bio: _BitReader) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.bits(2)
    if n != 3:
        return 3 + n
    n = bio.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bio.bits(7)


def _read_packet(data: bytes, pos: int, style: _Style, res: _Resolution, precno: int,
                 layer: int) -> int:
    """Read one packet at ``pos``: its header into the code-blocks' state and
    its body into their chunks; return the position after it."""
    if style.sop and data[pos:pos + 2] == b"\xff\x91":
        pos += 6
    bio = _BitReader(data, pos)
    included = []
    if bio.bit():
        for band in res.bands:
            cw, ch, blocks, incl, imsb = band.precincts[precno]
            for b, blk in enumerate(blocks):
                if not blk.included:
                    if not incl.decode(bio, b, layer + 1):
                        continue
                    zb = 0
                    while not imsb.decode(bio, b, zb):
                        zb += 1
                    blk.nbps = band.mb + 1 - zb
                    blk.included = True
                elif not bio.bit():
                    continue
                n = _num_passes(bio)
                while bio.bit():
                    blk.lblock += 1
                length = bio.bits(blk.lblock + n.bit_length() - 1)
                blk.passes += n
                included.append((blk, length))
    pos = bio.align()
    if style.eph and data[pos:pos + 2] == b"\xff\x92":
        pos += 2
    for blk, length in included:
        if pos + length > len(data):
            raise Jpeg2000Error("Truncated JPEG 2000 packet body")
        blk.chunks.append(data[pos:pos + length])
        pos += length
    return pos


def _packet_order(style: _Style, comps: list, tile: tuple) -> list:
    """(layer, resolution, component, precinct) of each packet in the order
    of the progression, as OpenJPEG's ``opj_pi_next_*`` visits them."""
    layers = style.layers
    prog = _PROGRESSIONS[style.progression]
    maxres = max(len(rs) for rs in comps)
    tx0, ty0, tx1, ty1 = tile
    order: list = []
    if prog in ("LRCP", "RLCP"):
        for a in range(layers if prog == "LRCP" else maxres):
            for b in range(maxres if prog == "LRCP" else layers):
                layer, r = (a, b) if prog == "LRCP" else (b, a)
                for c, rs in enumerate(comps):
                    if r < len(rs):
                        order += [(layer, r, c, p) for p in range(rs[r].pw * rs[r].ph)]
        return order
    seen: set = set()

    def steps(cs) -> tuple[int, int]:
        dx = min(1 << (rs[r].pdx + len(rs) - 1 - r) for c in cs for rs in (comps[c],)
                 for r in range(len(rs)))
        dy = min(1 << (rs[r].pdy + len(rs) - 1 - r) for c in cs for rs in (comps[c],)
                 for r in range(len(rs)))
        return dx, dy

    def visit(r: int, c: int, y: int, x: int) -> None:
        rs = comps[c]
        if r >= len(rs):
            return
        res = rs[r]
        level = len(rs) - 1 - r
        trx0, try0 = _ceil_div(tx0, 1 << level), _ceil_div(ty0, 1 << level)
        trx1, try1 = _ceil_div(tx1, 1 << level), _ceil_div(ty1, 1 << level)
        rpx, rpy = res.pdx + level, res.pdy + level
        if not (y % (1 << rpy) == 0 or (y == ty0 and (try0 << level) % (1 << rpy))):
            return
        if not (x % (1 << rpx) == 0 or (x == tx0 and (trx0 << level) % (1 << rpx))):
            return
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return
        prci = (_ceil_div(x, 1 << level) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_ceil_div(y, 1 << level) >> res.pdy) - (try0 >> res.pdy)
        p = prci + prcj * res.pw
        for layer in range(layers):
            if (layer, r, c, p) not in seen:
                seen.add((layer, r, c, p))
                order.append((layer, r, c, p))

    def grid(d: int, lo: int, hi: int):
        v = lo
        while v < hi:
            yield v
            v += d - v % d

    ncomp = len(comps)
    if prog == "RPCL":
        dx, dy = steps(range(ncomp))
        for r in range(maxres):
            for y in grid(dy, ty0, ty1):
                for x in grid(dx, tx0, tx1):
                    for c in range(ncomp):
                        visit(r, c, y, x)
    elif prog == "PCRL":
        dx, dy = steps(range(ncomp))
        for y in grid(dy, ty0, ty1):
            for x in grid(dx, tx0, tx1):
                for c in range(ncomp):
                    for r in range(len(comps[c])):
                        visit(r, c, y, x)
    else:  # CPRL
        for c in range(ncomp):
            dx, dy = steps([c])
            for y in grid(dy, ty0, ty1):
                for x in grid(dx, tx0, tx1):
                    for r in range(len(comps[c])):
                        visit(r, c, y, x)
    return order


# ---------------------------------------------------------------------------
# Inverse wavelets (OpenJPEG's dwt.c)
# ---------------------------------------------------------------------------


def _interleave(low: np.ndarray, high: np.ndarray, cas: int, axis: int) -> np.ndarray:
    n = low.shape[axis] + high.shape[axis]
    shape = list(low.shape)
    shape[axis] = n
    out = np.empty(shape, low.dtype)
    idx = [slice(None)] * low.ndim
    idx[axis] = slice(cas, n, 2)
    out[tuple(idx)] = low
    idx[axis] = slice(1 - cas, n, 2)
    out[tuple(idx)] = high
    return out


def _along(x: np.ndarray, axis: int, sl: slice) -> np.ndarray:
    idx = [slice(None)] * x.ndim
    idx[axis] = sl
    return x[tuple(idx)]


def _lift(x: np.ndarray, start: int, axis: int, fn) -> None:
    """Update positions ``start, start + 2, ...`` along ``axis`` in place
    from their two neighbours, with whole-sample symmetric extension at both
    ends (the neighbours are the other parity, which this step leaves)."""
    n = x.shape[axis]
    other = _along(x, axis, slice(1 - start, None, 2))
    target = _along(x, axis, slice(start, None, 2))
    m = target.shape[axis]
    if start == 0:  # before position 0 lies position 1
        before = np.concatenate([_along(other, axis, slice(0, 1)),
                                 _along(other, axis, slice(0, m - 1))], axis=axis)
    else:
        before = _along(other, axis, slice(0, m))
    after = _along(other, axis, slice(start, start + m))
    if after.shape[axis] < m:  # after the last position lies the one before it
        after = np.concatenate([after, _along(x, axis, slice(n - 2, n - 1))], axis=axis)
    target[...] = fn(target, before, after)


def _idwt53_1d(low: np.ndarray, high: np.ndarray, cas: int, axis: int) -> np.ndarray:
    x = _interleave(low, high, cas, axis)
    n = x.shape[axis]
    if n == 1:  # opj_idwt53: a lone high-pass sample is halved, as C's / does
        return (np.sign(x) * (np.abs(x) >> 1)).astype(x.dtype) if cas else x
    _lift(x, cas, axis, lambda s, a, b: s - ((a + b + 2) >> 2))
    _lift(x, 1 - cas, axis, lambda d, a, b: d + ((a + b) >> 1))
    return x


_F32 = np.float32
_ALPHA, _BETA = _F32(-1.586134342), _F32(-0.052980118)
_GAMMA, _DELTA = _F32(0.882911075), _F32(0.443506852)
_K, _TWO_INVK = _F32(1.230174105), _F32(1.625732422)


def _idwt97_1d(low: np.ndarray, high: np.ndarray, cas: int, axis: int) -> np.ndarray:
    x = _interleave(low, high, cas, axis)
    n = x.shape[axis]
    if n == 1:  # opj_v8dwt_decode leaves a single sample as it is
        return x
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(cas, None, 2)
    x[tuple(idx)] *= _K
    idx[axis] = slice(1 - cas, None, 2)
    x[tuple(idx)] *= _TWO_INVK
    for start, c in ((cas, -_DELTA), (1 - cas, -_GAMMA), (cas, -_BETA), (1 - cas, -_ALPHA)):
        _lift(x, start, axis, lambda t, a, b, c=c: t + (a + b) * c)
    return x


def _idwt(bands_by_res: list, rects: list, reversible: bool) -> np.ndarray:
    """Synthesize a tile-component from its bands: ``bands_by_res[0]`` the
    LL array, then (HL, LH, HH) per resolution; ``rects`` each resolution's
    (x0, y0, x1, y1)."""
    fn = _idwt53_1d if reversible else _idwt97_1d
    image = bands_by_res[0][0]
    for r in range(1, len(bands_by_res)):
        hl, lh, hh = bands_by_res[r]
        x0, y0 = rects[r][:2]
        top = fn(image, hl, x0 % 2, 1)  # rows first, then columns
        bottom = fn(lh, hh, x0 % 2, 1)
        image = fn(top, bottom, y0 % 2, 0)
    return image


# ---------------------------------------------------------------------------
# Tile decode
# ---------------------------------------------------------------------------


def _decode_tile(siz: _Siz, style: _Style, body: bytes, tile: tuple, plain: bool) -> list:
    """Decode one tile: each component's int64 samples ``[th, tw]`` after
    the DC level shift and the clamp to its range."""
    comps = []
    for c in range(siz.ncomp):
        comps.append(_resolutions(tile, style.coding[c], style.quant[c], siz.prec[c]))
    pos = 0
    for layer, r, c, p in _packet_order(style, comps, tile):
        if pos >= len(body):
            raise Jpeg2000Error("Truncated JPEG 2000 tile: packets missing")
        pos = _read_packet(body, pos, style, comps[c][r], p, layer)
    # Tier-1 over every code-block of the tile, in one call.
    rows, chunks, total, placed = [], [], 0, []
    offset = 0
    for c, rs in enumerate(comps):
        for res in rs:
            for band in res.bands:
                for prec in band.precincts:
                    for blk in prec[2]:
                        w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
                        data = b"".join(blk.chunks)
                        if blk.included and blk.nbps > 30:
                            raise Jpeg2000Error(f"{blk.nbps} bit-planes in a code-block")
                        rows.append((offset, len(data), w, h, band.orient,
                                     blk.nbps if blk.included else 0, blk.passes, total))
                        chunks.append(data)
                        placed.append((c, band, blk, total))
                        offset += len(data)
                        total += w * h
    blocks = np.asarray(rows, np.int64).reshape(-1, 8)
    data = np.frombuffer(b"".join(chunks) or b"\x00", np.uint8)
    coeffs = _t1_decode(data, blocks, total, plain)
    # Dequantize each band, then the inverse wavelet per component.
    arrays = {}
    for c, rs in enumerate(comps):
        reversible = style.coding[c].reversible
        for res in rs:
            for band in res.bands:
                shape = (band.y1 - band.y0, band.x1 - band.x0)
                arrays[(c, id(band))] = np.zeros(shape, np.int32 if reversible else np.float32)
    for c, band, blk, at in placed:
        w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
        q = coeffs[at:at + w * h].reshape(h, w)
        target = arrays[(c, id(band))]
        ys, xs = blk.y0 - band.y0, blk.x0 - band.x0
        if style.coding[c].reversible:
            target[ys:ys + h, xs:xs + w] = np.sign(q) * (np.abs(q) >> 1)
        else:
            target[ys:ys + h, xs:xs + w] = q.astype(np.float32) * (_F32(0.5) * band.step)
    planes = []
    for c, rs in enumerate(comps):
        bands = [[arrays[(c, id(b))] for b in res.bands] for res in rs]
        rects = [(res.x0, res.y0, res.x1, res.y1) for res in rs]
        planes.append(_idwt(bands, rects, style.coding[c].reversible))
    if style.mct and siz.ncomp >= 3:
        y, u, v = planes[:3]
        if style.coding[0].reversible:
            g = y - ((u + v) >> 2)
            planes[:3] = [v + g, g, u + g]
        else:
            planes[:3] = [y + v * _F32(1.402), y - u * _F32(0.34413) - v * _F32(0.71414),
                          y + u * _F32(1.772)]
    out = []
    for c, plane in enumerate(planes):
        prec, signed = siz.prec[c], siz.signed[c]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed else (0, (1 << prec) - 1)
        shift = 0 if signed else 1 << (prec - 1)
        if style.coding[c].reversible:
            values = plane.astype(np.int64)
        else:
            values = np.rint(plane).astype(np.int64)  # lrintf: round half to even
        out.append(np.clip(values + shift, lo, hi))
    return out


# ---------------------------------------------------------------------------
# Pillow's modes
# ---------------------------------------------------------------------------


def _jp2_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise Jpeg2000Error("Truncated JP2 box")
            length, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise Jpeg2000Error(f"Malformed JP2 box {kind!r}")
        yield kind, pos + head, pos + length
        pos += length


def _open(data: bytes) -> tuple[bytes, str, int | None]:
    """The codestream, Pillow's mode, and the JP2 colour space (None for a
    raw codestream)."""
    if data[:4] == CODESTREAM_MAGIC:
        if len(data) < 4 + 39:
            raise Jpeg2000Error("Truncated SIZ segment")
        ncomp = struct.unpack_from(">H", data, 4 + 36)[0]
        if ncomp == 1:
            mode = "I;16" if (data[4 + 38] & 0x7F) + 1 > 8 else "L"
        elif 2 <= ncomp <= 4:
            mode = ("LA", "RGB", "RGBA")[ncomp - 2]
        else:
            raise Jpeg2000Error("unable to determine J2K image mode")
        return data, mode, None
    if data[:12] != JP2_MAGIC:
        raise Jpeg2000Error("Not a JPEG 2000 file")
    mode = codestream = None
    enumcs = 0
    for kind, start, end in _jp2_boxes(data, 0, len(data)):
        if kind == b"jp2h":
            for sub, s0, s1 in _jp2_boxes(data, start, end):
                if sub == b"ihdr" and s1 - s0 >= 11:
                    _, _, nc, bpc = struct.unpack_from(">IIHB", data, s0)
                    if nc == 1:
                        mode = "I;16" if (bpc & 0x7F) > 8 else "L"
                    elif 2 <= nc <= 4:
                        mode = ("LA", "RGB", "RGBA")[nc - 2]
                elif sub == b"colr" and s1 - s0 >= 7:
                    if data[s0] == 1:
                        enumcs = struct.unpack_from(">I", data, s0 + 3)[0]
                elif sub == b"pclr":
                    raise _unsupported("a JP2 palette (pclr)")
        elif kind == b"jp2c":
            codestream = data[start:end]
            break
    if mode is None or codestream is None:
        raise Jpeg2000Error("Malformed JP2 header")
    return codestream, mode, enumcs


def _ycbcr_tables() -> tuple:
    """Pillow's ``ImagingConvertYCbCr2RGB`` tables (``ConvertYCbCr.c``: 6
    fractional bits, each entry C's ``(int)(k * (c - 128) * 64 + 0.5)``;
    found by holding every (Cb, Cr) pair to Pillow's conversion)."""
    c = np.arange(256, dtype=np.float64) - 128
    return tuple(np.trunc(k * c * 64 + 0.5).astype(np.int64)
                 for k in (1.402, -0.34414, -0.71414, 1.772))


def _pillow_samples(values: np.ndarray, prec: int, signed: bool, width: int) -> np.ndarray:
    """Pillow's ``j2ku_shift(offset + word, shift)`` of one component to a
    ``width``-bit sample (8 or 16), truncated to it as its C stores do."""
    csiz = (prec + 7) >> 3
    word = values & ((1 << (8 * csiz)) - 1)
    shift = width - prec
    offset = (1 << (prec - 1)) if signed else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        out = (offset + word) >> -shift
    else:
        out = (offset + word) << shift
    return (out & ((1 << width) - 1)).astype(np.uint8 if width == 8 else np.uint16)


def decode_jpeg2000(data: bytes, plain: bool = False) -> np.ndarray:
    """Decode a JPEG 2000 codestream or JP2 file as Pillow does: ``L``
    uint8 ``[H, W]``, ``I;16`` uint16 ``[H, W]``, ``LA``, ``RGB`` or
    ``RGBA`` uint8 ``[H, W, 2|3|4]``. ``plain`` runs tier-1 with the Python
    version instead of the C++ one (the tests' reference)."""
    data = bytes(data)
    codestream, mode, enumcs = _open(data)
    siz, _, tiles = _parse_codestream(codestream)
    if enumcs is None:  # a raw codestream's colour space is unspecified
        space = "gray" if siz.ncomp <= 2 else "srgb"
    else:
        space = {16: "srgb", 17: "gray", 18: "sycc"}.get(enumcs)
        if space is None:
            raise _unsupported(f"JP2 colour space {enumcs}")
    expected = {"L": (1, "gray"), "I;16": (1, "gray"), "LA": (2, "gray"),
                "RGB": (3, "srgb"), "RGBA": (4, "srgb")}[mode]
    if siz.ncomp != expected[0] or (space != expected[1] and not (
            space == "sycc" and siz.ncomp >= 3)):
        raise _unsupported(f"a {siz.ncomp}-component {space} JPEG 2000 image in mode {mode}")
    width, height = siz.xsiz - siz.x0, siz.ysiz - siz.y0
    nx = _ceil_div(siz.xsiz - siz.tx0, siz.tw)
    ny = _ceil_div(siz.ysiz - siz.ty0, siz.th)
    bits = 16 if mode == "I;16" else 8
    out = np.zeros((height, width, siz.ncomp), np.uint16 if bits == 16 else np.uint8)
    for t in range(nx * ny):
        p, q = t % nx, t // nx
        tx0 = max(siz.tx0 + p * siz.tw, siz.x0)
        ty0 = max(siz.ty0 + q * siz.th, siz.y0)
        tx1 = min(siz.tx0 + (p + 1) * siz.tw, siz.xsiz)
        ty1 = min(siz.ty0 + (q + 1) * siz.th, siz.ysiz)
        style, body = tiles.get(t, (None, None))
        if style is None:
            raise Jpeg2000Error(f"Tile {t} is missing")
        planes = _decode_tile(siz, style, body, (tx0, ty0, tx1, ty1), plain)
        for c, plane in enumerate(planes):
            out[ty0 - siz.y0:ty1 - siz.y0, tx0 - siz.x0:tx1 - siz.x0, c] = _pillow_samples(
                plane, siz.prec[c], siz.signed[c], bits)
    if space == "sycc":
        r_cr, g_cb, g_cr, b_cb = _ycbcr_tables()
        y = out[..., 0].astype(np.int64)
        cb, cr = out[..., 1], out[..., 2]
        out[..., :3] = np.clip(np.stack([y + (r_cr[cr] >> 6), y + ((g_cb[cb] + g_cr[cr]) >> 6),
                                         y + (b_cb[cb] >> 6)], -1), 0, 255)
    return out[..., 0] if siz.ncomp == 1 else out


def to_rgb(image: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of a decoded image: ``L`` and ``LA``
    replicate the gray (dropping alpha), ``I;16`` clips to 255 and
    replicates, ``RGBA`` drops alpha."""
    img = np.asarray(image)
    if img.ndim == 2:
        gray = np.minimum(img, 255).astype(np.uint8) if img.dtype == np.uint16 else img
        return np.repeat(gray[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])

