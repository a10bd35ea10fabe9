"""PDF fonts: embedded TrueType, CFF and Type 3 glyphs as outlines (ISO
32000-1 §9.6-9.9), for ``io/pdf_render.py``.

- TrueType (``FontFile2``): ``head``, ``maxp``, ``loca``, ``glyf`` with composite
  glyphs (offsets, scales, 2 x 2 transforms), ``hhea``/``hmtx`` and
  ``cmap`` formats 0, 4, 6 and 12 (platforms 3/1, 3/0, 3/10, 1/0). It serves
  simple TrueType fonts and Type0 fonts whose descendant is a CIDFontType2
  (``Identity-H``, ``CIDToGIDMap`` identity or a stream), the form
  matplotlib's ``pdf.fonttype 42`` and most report generators write.
- CFF (``FontFile3`` of subtype ``Type1C``): the INDEXes, Top and Private
  DICTs, charsets 0-2, encodings 0-1 and Type 2 charstrings with local and
  global subroutines, hints skipped, flex drawn as its two curves.
- Type 3: :class:`Type3Font` names each code's glyph procedure; the
  renderer runs it through ``FontMatrix``.
- Encodings: Standard, WinAnsi and MacRoman (``io/pdf_tables.py``), with
  ``/Differences``; a simple TrueType font maps a code through its glyph
  name's Unicode to ``cmap`` 3/1, else through 3/0 (``0xF000 + code``
  too), else 1/0, as MuPDF does. Widths from ``/Widths`` (``FirstChar``,
  ``MissingWidth``) or from ``/W`` and ``/DW``.

A font that is not embedded (MuPDF substitutes its built-in fonts, which the
port does not ship), a Type 1 font program (``FontFile``), ``FontFile3``
programs other than Type1C (CID-keyed CFF, OpenType), a CMap other than
``Identity-H`` (vertical writing, predefined or embedded CMaps), TrueType
point-matched components and charstring operators outside the path set
(``seac``-style accents, arithmetic) raise ``NotImplementedError`` naming
ROADMAP Queue 1 item 13.

Glyph outlines are lists of closed contours in text space (one unit a text
space unit: the font's units over ``unitsPerEm``, or through ``FontMatrix``),
each contour a list of ``("M", x, y)``, ``("L", x, y)``, ``("Q", x1, y1, x,
y)`` and ``("C", x1, y1, x2, y2, x, y)``.
"""

from __future__ import annotations

import re
import struct

from spine_vision_torch.io import pdf_tables
from spine_vision_torch.io.pdf_parse import Name, Stream, unsupported

_ENCODINGS = {"StandardEncoding": pdf_tables.STANDARD_ENCODING,
              "WinAnsiEncoding": pdf_tables.WIN_ANSI_ENCODING,
              "MacRomanEncoding": pdf_tables.MAC_ROMAN_ENCODING}


def glyph_unicode(name: str | None) -> int | None:
    """The Unicode value of a glyph name: the Adobe Glyph List's names of
    the three encodings, ``uniXXXX`` and ``uXXXX[XX]``."""
    if not name:
        return None
    if name in pdf_tables.GLYPH_UNICODE:
        return pdf_tables.GLYPH_UNICODE[name]
    base = name.split(".")[0]
    if base in pdf_tables.GLYPH_UNICODE:
        return pdf_tables.GLYPH_UNICODE[base]
    m = re.fullmatch(r"uni([0-9A-Fa-f]{4})", base) or re.fullmatch(r"u([0-9A-Fa-f]{4,6})", base)
    if m:
        return int(m.group(1), 16)
    return None


# -- TrueType --------------------------------------------------------------------
class TrueType:
    """Outlines of a TrueType (``glyf``) font program."""

    def __init__(self, data: bytes):
        self.data = data
        if data[:4] == b"ttcf":
            raise unsupported("a TrueType collection")
        num = struct.unpack_from(">H", data, 4)[0]
        self.tables = {}
        for i in range(num):
            tag, _, off, length = struct.unpack_from(">4sIII", data, 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (off, length)
        head = self.table("head")
        self.units_per_em = struct.unpack_from(">H", head, 18)[0] or 1000
        self.loca_long = struct.unpack_from(">h", head, 50)[0] == 1
        self.num_glyphs = struct.unpack_from(">H", self.table("maxp"), 4)[0]
        loca = self.table("loca")
        n = self.num_glyphs + 1
        if self.loca_long:
            self.loca = list(struct.unpack_from(f">{n}I", loca, 0)) if len(loca) >= 4 * n else []
        else:
            self.loca = [2 * v for v in struct.unpack_from(f">{n}H", loca, 0)] if len(loca) >= 2 * n else []
        self.glyf = self.table("glyf")
        self.cmaps = self._cmaps()
        self.cache: dict[int, list] = {}

    def table(self, tag: str) -> bytes:
        if tag not in self.tables:
            return b""
        off, length = self.tables[tag]
        return self.data[off:off + length]

    def _cmaps(self) -> dict:
        cmap = self.table("cmap")
        out = {}
        if len(cmap) < 4:
            return out
        n = struct.unpack_from(">H", cmap, 2)[0]
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", cmap, 4 + 8 * i)
            if (pid, eid) in out:
                continue
            try:
                out[(pid, eid)] = _parse_cmap(cmap, off)
            except (struct.error, IndexError):
                continue
        return out

    def outline(self, gid: int, depth: int = 0) -> list:
        if gid in self.cache:
            return self.cache[gid]
        contours = self._outline(gid, depth)
        scale = 1.0 / self.units_per_em
        out = [[(op[0], *(v * scale for v in op[1:])) for op in c] for c in contours]
        if depth == 0:
            self.cache[gid] = out
        return out

    def _raw_points(self, gid: int, depth: int) -> list:
        """Contours as lists of (x, y, on_curve) in font units."""
        if depth > 8 or not self.loca or gid < 0 or gid >= self.num_glyphs:
            return []
        start, end = self.loca[gid], self.loca[gid + 1]
        if end <= start:
            return []
        g = self.glyf[start:end]
        ncont = struct.unpack_from(">h", g, 0)[0]
        if ncont >= 0:
            return _simple_glyph(g, ncont)
        contours = []
        pos = 10
        while True:
            flags, glyph = struct.unpack_from(">HH", g, pos)
            pos += 4
            if flags & 1:
                a, b = struct.unpack_from(">hh", g, pos)
                pos += 4
            else:
                a, b = struct.unpack_from(">bb", g, pos)
                pos += 2
            if not flags & 2:
                raise unsupported("a TrueType component placed by point numbers")
            m = (1.0, 0.0, 0.0, 1.0)
            if flags & 0x8:
                s = struct.unpack_from(">h", g, pos)[0] / 16384.0
                pos += 2
                m = (s, 0.0, 0.0, s)
            elif flags & 0x40:
                sx, sy = (v / 16384.0 for v in struct.unpack_from(">hh", g, pos))
                pos += 4
                m = (sx, 0.0, 0.0, sy)
            elif flags & 0x80:
                m = tuple(v / 16384.0 for v in struct.unpack_from(">hhhh", g, pos))
                pos += 8
            dx, dy = float(a), float(b)
            if flags & 0x800:  # SCALED_COMPONENT_OFFSET
                dx, dy = dx * m[0] + dy * m[2], dx * m[1] + dy * m[3]
            for c in self._raw_points(glyph, depth + 1):
                contours.append([(x * m[0] + y * m[2] + dx, x * m[1] + y * m[3] + dy, on)
                                 for x, y, on in c])
            if not flags & 0x20:
                break
        return contours

    def _outline(self, gid: int, depth: int) -> list:
        return [_quad_contour(c) for c in self._raw_points(gid, depth) if c]


def _simple_glyph(g: bytes, ncont: int) -> list:
    ends = struct.unpack_from(f">{ncont}H", g, 10)
    npts = ends[-1] + 1 if ncont else 0
    pos = 10 + 2 * ncont
    ilen = struct.unpack_from(">H", g, pos)[0]
    pos += 2 + ilen
    flags = []
    while len(flags) < npts:
        f = g[pos]
        pos += 1
        flags.append(f)
        if f & 8:
            r = g[pos]
            pos += 1
            flags.extend([f] * r)
    flags = flags[:npts]
    coords = []
    for short, same in ((2, 16), (4, 32)):
        v = 0
        vals = []
        for f in flags:
            if f & short:
                d = g[pos]
                pos += 1
                v += d if f & same else -d
            elif not f & same:
                v += struct.unpack_from(">h", g, pos)[0]
                pos += 2
            vals.append(v)
        coords.append(vals)
    xs, ys = coords
    out = []
    start = 0
    for e in ends:
        out.append([(float(xs[i]), float(ys[i]), bool(flags[i] & 1)) for i in range(start, e + 1)])
        start = e + 1
    return out


def _quad_contour(pts: list) -> list:
    """A TrueType contour (on- and off-curve points) as M/L/Q operators."""
    n = len(pts)
    first = next((i for i, p in enumerate(pts) if p[2]), None)
    if first is None:  # all off-curve: start at the first midpoint
        p0, p1 = pts[0], pts[1 % n]
        start = ((p0[0] + p1[0]) / 2, (p0[1] + p1[1]) / 2)
        order = pts[1:] + pts[:1]
    else:
        start = pts[first][:2]
        order = pts[first + 1:] + pts[:first]
    ops = [("M", *start)]
    ctrl = None
    for x, y, on in order + [(start[0], start[1], True)]:
        if on:
            if ctrl is None:
                ops.append(("L", x, y))
            else:
                ops.append(("Q", ctrl[0], ctrl[1], x, y))
                ctrl = None
        else:
            if ctrl is not None:
                mx, my = (ctrl[0] + x) / 2, (ctrl[1] + y) / 2
                ops.append(("Q", ctrl[0], ctrl[1], mx, my))
            ctrl = (x, y)
    return ops


def _parse_cmap(cmap: bytes, off: int) -> dict:
    fmt = struct.unpack_from(">H", cmap, off)[0]
    out: dict[int, int] = {}
    if fmt == 0:
        for c in range(256):
            out[c] = cmap[off + 6 + c]
    elif fmt == 4:
        segx2 = struct.unpack_from(">H", cmap, off + 6)[0]
        n = segx2 // 2
        ends = struct.unpack_from(f">{n}H", cmap, off + 14)
        starts = struct.unpack_from(f">{n}H", cmap, off + 16 + segx2)
        deltas = struct.unpack_from(f">{n}h", cmap, off + 16 + 2 * segx2)
        ro_at = off + 16 + 3 * segx2
        ros = struct.unpack_from(f">{n}H", cmap, ro_at)
        for i in range(n):
            for c in range(starts[i], ends[i] + 1):
                if c == 0xFFFF:
                    continue
                if ros[i] == 0:
                    g = (c + deltas[i]) & 0xFFFF
                else:
                    at = ro_at + 2 * i + ros[i] + 2 * (c - starts[i])
                    g = struct.unpack_from(">H", cmap, at)[0]
                    if g:
                        g = (g + deltas[i]) & 0xFFFF
                if g:
                    out[c] = g
    elif fmt == 6:
        first, count = struct.unpack_from(">HH", cmap, off + 6)
        for i, g in enumerate(struct.unpack_from(f">{count}H", cmap, off + 10)):
            out[first + i] = g
    elif fmt == 12:
        n = struct.unpack_from(">I", cmap, off + 12)[0]
        for i in range(n):
            s, e, g = struct.unpack_from(">III", cmap, off + 16 + 12 * i)
            for c in range(s, min(e, s + 0x10000) + 1):
                out[c] = g + c - s
    return out


# -- CFF ---------------------------------------------------------------------------------
def _index(data: bytes, pos: int) -> tuple[list[bytes], int]:
    count = struct.unpack_from(">H", data, pos)[0]
    if count == 0:
        return [], pos + 2
    size = data[pos + 2]
    offs = []
    at = pos + 3
    for _ in range(count + 1):
        offs.append(int.from_bytes(data[at:at + size], "big"))
        at += size
    base = at - 1
    items = [data[base + offs[i]:base + offs[i + 1]] for i in range(count)]
    return items, base + offs[-1]


def _dict(data: bytes) -> dict:
    out: dict = {}
    ops: list = []
    i = 0
    while i < len(data):
        b = data[i]
        if b <= 21:
            if b == 12:
                key = 1200 + data[i + 1]
                i += 2
            else:
                key = b
                i += 1
            out[key] = ops
            ops = []
        elif b == 28:
            ops.append(struct.unpack_from(">h", data, i + 1)[0])
            i += 3
        elif b == 29:
            ops.append(struct.unpack_from(">i", data, i + 1)[0])
            i += 5
        elif b == 30:
            s = ""
            i += 1
            done = False
            while not done:
                byte = data[i]
                i += 1
                for nib in (byte >> 4, byte & 15):
                    if nib == 0xF:
                        done = True
                        break
                    s += "0123456789.EE?-"[nib] + ("-" if nib == 0xC else "")
            ops.append(float(s.replace("E-", "E-").replace("?", "")) if s else 0.0)
        elif 32 <= b <= 246:
            ops.append(b - 139)
            i += 1
        elif 247 <= b <= 250:
            ops.append((b - 247) * 256 + data[i + 1] + 108)
            i += 2
        elif 251 <= b <= 254:
            ops.append(-(b - 251) * 256 - data[i + 1] - 108)
            i += 2
        else:
            i += 1
    return out


def _bias(n: int) -> int:
    return 107 if n < 1240 else 1131 if n < 33900 else 32768


class CFF:
    """Outlines of a CFF font program (the first font of its FontSet)."""

    def __init__(self, data: bytes):
        self.data = data
        pos = data[2]
        names, pos = _index(data, pos)
        tops, pos = _index(data, pos)
        strings, pos = _index(data, pos)
        self.gsubrs, pos = _index(data, pos)
        if not tops:
            raise unsupported("a CFF font with no Top DICT")
        self.strings = strings
        top = _dict(tops[0])
        self.matrix = [float(v) for v in top.get(1207, [0.001, 0, 0, 0.001, 0, 0])]
        if top.get(1206, [2])[0] != 2:
            raise unsupported("CFF charstrings other than Type 2")
        if 1230 in top:
            raise unsupported("a CID-keyed CFF font")
        self.charstrings, _ = _index(data, top[17][0])
        n = len(self.charstrings)
        self.private = self._private(top)
        self.charset = self._charset(top.get(15, [0])[0], n)  # gid -> SID
        self.names: dict[str, int] = {}
        for gid, sid in enumerate(self.charset):
            self.names.setdefault(self.sid_name(sid), gid)
        self.builtin = self._encoding(top.get(16, [0])[0])
        self.cache: dict[int, list] = {}

    def _private(self, d: dict) -> tuple:
        if 18 not in d:
            return ([], 0.0, 0.0)
        size, off = d[18][:2]
        p = _dict(self.data[off:off + size])
        subrs = _index(self.data, off + p[19][0])[0] if 19 in p else []
        return (subrs, p.get(20, [0])[0], p.get(21, [0])[0])

    def sid_name(self, sid: int) -> str:
        if sid < len(pdf_tables.CFF_STANDARD_STRINGS):
            return pdf_tables.CFF_STANDARD_STRINGS[sid]
        i = sid - len(pdf_tables.CFF_STANDARD_STRINGS)
        return self.strings[i].decode("latin-1") if i < len(self.strings) else ""

    def _charset(self, off: int, n: int) -> list:
        if off in (0, 1, 2):  # ISOAdobe (and the expert sets, read the same way)
            return list(range(n))
        data = self.data
        fmt = data[off]
        out = [0]
        pos = off + 1
        if fmt == 0:
            out += list(struct.unpack_from(f">{n - 1}H", data, pos))
        elif fmt in (1, 2):
            while len(out) < n:
                first = struct.unpack_from(">H", data, pos)[0]
                if fmt == 1:
                    left = data[pos + 2]
                    pos += 3
                else:
                    left = struct.unpack_from(">H", data, pos + 2)[0]
                    pos += 4
                out += list(range(first, first + left + 1))
        else:
            raise unsupported(f"CFF charset format {fmt}")
        return out[:n]

    def _encoding(self, off: int) -> dict:
        """code -> gid of the font's own encoding."""
        if off in (0, 1):
            out = {}
            for code, name in enumerate(pdf_tables.STANDARD_ENCODING):
                if name and name in self.names:
                    out[code] = self.names[name]
            return out
        data = self.data
        fmt = data[off] & 0x7F
        out = {}
        if fmt == 0:
            for gid, code in enumerate(data[off + 2:off + 2 + data[off + 1]], 1):
                out[code] = gid
        elif fmt == 1:
            gid = 1
            for i in range(data[off + 1]):
                first, left = data[off + 2 + 2 * i], data[off + 3 + 2 * i]
                for code in range(first, first + left + 1):
                    out[code] = gid
                    gid += 1
        return out

    def outline(self, gid: int) -> list:
        if gid in self.cache:
            return self.cache[gid]
        if not 0 <= gid < len(self.charstrings):
            return []
        contours = _type2(self.charstrings[gid], self.private[0], self.gsubrs)
        a, b, c, d, e, f = self.matrix
        out = []
        for cont in contours:
            ops = []
            for op in cont:
                pts = op[1:]
                xy = []
                for i in range(0, len(pts), 2):
                    x, y = pts[i], pts[i + 1]
                    xy += [a * x + c * y + e, b * x + d * y + f]
                ops.append((op[0], *xy))
            out.append(ops)
        self.cache[gid] = out
        return out


def _type2(code: bytes, subrs: list, gsubrs: list) -> list:
    """Run a Type 2 charstring: its contours in glyph units."""
    contours: list = []
    cur: list = []
    stack: list = []
    x = y = 0.0
    nstems = 0
    width_done = False
    lbias, gbias = _bias(len(subrs)), _bias(len(gsubrs))

    def moveto(nx, ny):
        nonlocal x, y, cur
        if cur:
            contours.append(cur)
        x, y = nx, ny
        cur = [("M", x, y)]

    def lineto(nx, ny):
        nonlocal x, y
        if not cur:
            moveto(x, y)
        x, y = nx, ny
        cur.append(("L", x, y))

    def curveto(dx1, dy1, dx2, dy2, dx3, dy3):
        nonlocal x, y
        if not cur:
            moveto(x, y)
        x1, y1 = x + dx1, y + dy1
        x2, y2 = x1 + dx2, y1 + dy2
        x, y = x2 + dx3, y2 + dy3
        cur.append(("C", x1, y1, x2, y2, x, y))

    def run(prog: bytes, depth: int) -> bool:
        nonlocal nstems, width_done, stack
        if depth > 10:
            raise unsupported("charstring subroutines nested past 10")
        i = 0
        n = len(prog)
        while i < n:
            b = prog[i]
            if b >= 32 or b == 28:
                if b == 28:
                    stack.append(float(struct.unpack_from(">h", prog, i + 1)[0]))
                    i += 3
                elif b <= 246:
                    stack.append(float(b - 139))
                    i += 1
                elif b <= 250:
                    stack.append(float((b - 247) * 256 + prog[i + 1] + 108))
                    i += 2
                elif b <= 254:
                    stack.append(float(-(b - 251) * 256 - prog[i + 1] - 108))
                    i += 2
                else:
                    stack.append(struct.unpack_from(">i", prog, i + 1)[0] / 65536.0)
                    i += 5
                continue
            i += 1
            if b in (1, 3, 18, 23):  # stems
                if not width_done and len(stack) % 2:
                    stack = stack[1:]
                width_done = True
                nstems += len(stack) // 2
                stack = []
            elif b in (19, 20):  # hintmask, cntrmask
                if not width_done and len(stack) % 2:
                    stack = stack[1:]
                width_done = True
                nstems += len(stack) // 2
                stack = []
                i += (nstems + 7) // 8
            elif b in (21, 22, 4):  # moveto
                need = 2 if b == 21 else 1
                if not width_done and len(stack) > need:
                    stack = stack[1:]
                width_done = True
                if b == 21:
                    moveto(x + stack[0], y + stack[1])
                elif b == 22:
                    moveto(x + stack[0], y)
                else:
                    moveto(x, y + stack[0])
                stack = []
            elif b == 5:
                for k in range(0, len(stack) - 1, 2):
                    lineto(x + stack[k], y + stack[k + 1])
                stack = []
            elif b in (6, 7):
                horiz = b == 6
                for v in stack:
                    lineto(x + v, y) if horiz else lineto(x, y + v)
                    horiz = not horiz
                stack = []
            elif b == 8:
                for k in range(0, len(stack) - 5, 6):
                    curveto(*stack[k:k + 6])
                stack = []
            elif b == 24:  # rcurveline
                k = 0
                while k + 6 <= len(stack) - 2:
                    curveto(*stack[k:k + 6])
                    k += 6
                lineto(x + stack[k], y + stack[k + 1])
                stack = []
            elif b == 25:  # rlinecurve
                k = 0
                while k + 2 <= len(stack) - 6:
                    lineto(x + stack[k], y + stack[k + 1])
                    k += 2
                curveto(*stack[k:k + 6])
                stack = []
            elif b == 26:  # vvcurveto
                k = 0
                dx1 = 0.0
                if len(stack) % 4:
                    dx1 = stack[0]
                    k = 1
                while k + 4 <= len(stack):
                    curveto(dx1, stack[k], stack[k + 1], stack[k + 2], 0.0, stack[k + 3])
                    dx1 = 0.0
                    k += 4
                stack = []
            elif b == 27:  # hhcurveto
                k = 0
                dy1 = 0.0
                if len(stack) % 4:
                    dy1 = stack[0]
                    k = 1
                while k + 4 <= len(stack):
                    curveto(stack[k], dy1, stack[k + 1], stack[k + 2], stack[k + 3], 0.0)
                    dy1 = 0.0
                    k += 4
                stack = []
            elif b in (30, 31):  # vhcurveto, hvcurveto
                horiz = b == 31
                k = 0
                s = stack
                while k + 4 <= len(s):
                    last = len(s) - k == 5
                    extra = s[k + 4] if last else 0.0
                    if horiz:
                        curveto(s[k], 0.0, s[k + 1], s[k + 2], extra, s[k + 3])
                    else:
                        curveto(0.0, s[k], s[k + 1], s[k + 2], s[k + 3], extra)
                    horiz = not horiz
                    k += 4
                stack = []
            elif b in (10, 29):  # callsubr, callgsubr
                idx = int(stack.pop()) + (lbias if b == 10 else gbias)
                table = subrs if b == 10 else gsubrs
                if not 0 <= idx < len(table):
                    raise unsupported("a charstring subroutine out of range")
                if run(table[idx], depth + 1):
                    return True
            elif b == 11:  # return
                return False
            elif b == 14:  # endchar
                if not width_done and len(stack) in (1, 5):
                    stack = stack[1:]
                if len(stack) >= 4:
                    raise unsupported("an accented (seac) Type 2 endchar")
                return True
            elif b == 12:
                e = prog[i]
                i += 1
                s = stack
                if e == 35:  # flex
                    curveto(*s[0:6])
                    curveto(*s[6:12])
                elif e == 34:  # hflex
                    y0 = y
                    curveto(s[0], 0.0, s[1], s[2], s[3], 0.0)
                    curveto(s[4], 0.0, s[5], y0 - y, s[6], 0.0)
                elif e == 36:  # hflex1
                    y0 = y
                    curveto(s[0], s[1], s[2], s[3], s[4], 0.0)
                    curveto(s[5], 0.0, s[6], s[7], s[8], y0 - y)
                elif e == 37:  # flex1
                    x0, y0 = x, y
                    dx = sum(s[0:10:2])
                    dy = sum(s[1:10:2])
                    curveto(*s[0:6])
                    if abs(dx) > abs(dy):
                        curveto(s[6], s[7], s[8], s[9], s[10], y0 - y - s[7] - s[9])
                    else:
                        curveto(s[6], s[7], s[8], s[9], x0 - x - s[6] - s[8], s[10])
                else:
                    raise unsupported(f"the Type 2 charstring operator 12 {e}")
                stack = []
            else:
                raise unsupported(f"the Type 2 charstring operator {b}")
        return False

    run(code, 0)
    if cur:
        contours.append(cur)
    return contours


# -- PDF font objects ------------------------------------------------------------------
class Glyph:
    """One shown code: its bytes' length, the glyph (gid, or a Type 3
    procedure's name) and its advance in text space."""

    __slots__ = ("code", "nbytes", "glyph", "width")

    def __init__(self, code: int, nbytes: int, glyph, width: float):
        self.code, self.nbytes, self.glyph, self.width = code, nbytes, glyph, width


def _font_program(doc, desc: dict):
    """The embedded font program of a font descriptor: TrueType or CFF."""
    for key in ("FontFile2", "FontFile3", "FontFile"):
        ref = desc.get(key)
        if ref is None:
            continue
        stream = doc.resolve(ref)
        if not isinstance(stream, Stream):
            continue
        if key == "FontFile":
            raise unsupported("a Type 1 font program (FontFile)")
        data = stream.data()
        sub = str(doc.resolve(stream.get("Subtype")) or "")
        if key == "FontFile2":
            return TrueType(data)
        if sub == "Type1C":
            return CFF(data)
        raise unsupported(f"a {sub or 'FontFile3'} font program")
    return None


def _not_embedded(name) -> NotImplementedError:
    return unsupported(f"the font {name} is not embedded (no built-in fonts in the port)")


class SimpleFont:
    """A single-byte font (TrueType or Type1C) with an embedded
    program."""

    def __init__(self, doc, font: dict):
        self.doc = doc
        desc = doc.resolve(font.get("FontDescriptor")) or {}
        self.program = _font_program(doc, desc)
        if self.program is None:
            raise _not_embedded(font.get("BaseFont"))
        first = int(doc.resolve(font.get("FirstChar", 0)) or 0)
        widths = doc.resolve(font.get("Widths")) or []
        missing = float(doc.resolve(desc.get("MissingWidth", 0)) or 0)
        self.widths = [missing / 1000.0] * 256
        for i, w in enumerate(widths):
            if 0 <= first + i < 256:
                self.widths[first + i] = float(doc.resolve(w)) / 1000.0
        flags = int(doc.resolve(desc.get("Flags", 0)) or 0)
        symbolic = bool(flags & 4) and not flags & 32
        names = self._names(font, symbolic)
        self.gids = [self._gid(code, names[code], symbolic) for code in range(256)]

    def _names(self, font: dict, symbolic: bool) -> list:
        enc = self.doc.resolve(font.get("Encoding"))
        base = None
        diffs = []
        if isinstance(enc, str):
            base = _ENCODINGS.get(str(enc))
            if base is None:
                raise unsupported(f"the encoding {enc}")
        elif isinstance(enc, dict):
            b = self.doc.resolve(enc.get("BaseEncoding"))
            if b is not None:
                base = _ENCODINGS.get(str(b))
            diffs = self.doc.resolve(enc.get("Differences")) or []
        if base is None:
            base = (None,) * 256 if symbolic else pdf_tables.STANDARD_ENCODING
            if isinstance(self.program, TrueType) and not symbolic:
                base = pdf_tables.STANDARD_ENCODING
        names = list(base)
        code = 0
        for item in diffs:
            item = self.doc.resolve(item)
            if isinstance(item, (int, float)) and not isinstance(item, bool):
                code = int(item)
            elif isinstance(item, Name):
                if 0 <= code < 256:
                    names[code] = str(item)
                code += 1
        return names

    def _gid(self, code: int, name, symbolic: bool) -> int:
        prog = self.program
        if isinstance(prog, CFF):
            if name is not None and name in prog.names:
                return prog.names[name]
            return prog.builtin.get(code, 0)
        cm = prog.cmaps
        if (3, 1) in cm or (3, 10) in cm:
            table = cm.get((3, 1)) or cm[(3, 10)]
            u = glyph_unicode(name)
            if u is not None and u in table:
                return table[u]
        if (3, 0) in cm:
            table = cm[(3, 0)]
            for c in (code, 0xF000 + code, 0xF100 + code, 0xF200 + code):
                if c in table:
                    return table[c]
        if (1, 0) in cm:
            table = cm[(1, 0)]
            if name is not None and name in pdf_tables.MAC_ROMAN_ENCODING:
                mac = pdf_tables.MAC_ROMAN_ENCODING.index(name)
                if mac in table:
                    return table[mac]
            if code in table:
                return table[code]
        return 0

    def decode(self, s: bytes) -> list[Glyph]:
        return [Glyph(c, 1, self.gids[c], self.widths[c]) for c in s]

    def outline(self, gid) -> list:
        return self.program.outline(gid)


class Type0Font:
    """A composite font with an ``Identity-H`` CMap over a CIDFontType2
    (TrueType) descendant."""

    def __init__(self, doc, font: dict):
        enc = doc.resolve(font.get("Encoding"))
        if not (isinstance(enc, Name) and enc == "Identity-H"):
            what = enc if isinstance(enc, Name) else "an embedded CMap"
            raise unsupported(f"the CMap {what} (only Identity-H is read)")
        desc_font = doc.resolve((doc.resolve(font.get("DescendantFonts")) or [None])[0]) or {}
        desc = doc.resolve(desc_font.get("FontDescriptor")) or {}
        self.program = _font_program(doc, desc)
        if self.program is None:
            raise _not_embedded(font.get("BaseFont"))
        if not isinstance(self.program, TrueType):
            raise unsupported("a Type0 font over a CFF program")
        self.default_width = float(doc.resolve(desc_font.get("DW", 1000))) / 1000.0
        self.widths: dict[int, float] = {}
        w = doc.resolve(desc_font.get("W")) or []
        i = 0
        while i < len(w):
            first = int(doc.resolve(w[i]))
            nxt = doc.resolve(w[i + 1]) if i + 1 < len(w) else None
            if isinstance(nxt, list):
                for k, v in enumerate(nxt):
                    self.widths[first + k] = float(doc.resolve(v)) / 1000.0
                i += 2
            else:
                last = int(nxt)
                v = float(doc.resolve(w[i + 2])) / 1000.0
                for c in range(first, last + 1):
                    self.widths[c] = v
                i += 3
        self.cid_to_gid = None
        m = doc.resolve(desc_font.get("CIDToGIDMap"))
        if isinstance(m, Stream):
            data = m.data()
            self.cid_to_gid = [int.from_bytes(data[k:k + 2], "big") for k in range(0, len(data) - 1, 2)]

    def gid(self, cid: int) -> int:
        if self.cid_to_gid is not None:
            return self.cid_to_gid[cid] if cid < len(self.cid_to_gid) else 0
        return cid

    def decode(self, s: bytes) -> list[Glyph]:
        out = []
        for k in range(0, len(s) - 1, 2):
            cid = (s[k] << 8) | s[k + 1]
            out.append(Glyph(cid, 2, self.gid(cid), self.widths.get(cid, self.default_width)))
        return out

    def outline(self, gid) -> list:
        return self.program.outline(gid)


class Type3Font:
    """A Type 3 font: each code's glyph procedure (a content stream) under
    ``FontMatrix``, with the font's resources."""

    def __init__(self, doc, font: dict):
        self.doc = doc
        self.matrix = [float(doc.resolve(v)) for v in doc.resolve(font.get("FontMatrix"))]
        self.procs = doc.resolve(font.get("CharProcs")) or {}
        self.resources = doc.resolve(font.get("Resources"))
        first = int(doc.resolve(font.get("FirstChar", 0)) or 0)
        widths = doc.resolve(font.get("Widths")) or []
        self.widths = [0.0] * 256
        for i, w in enumerate(widths):
            if 0 <= first + i < 256:
                self.widths[first + i] = float(doc.resolve(w)) * self.matrix[0]
        enc = doc.resolve(font.get("Encoding")) or {}
        self.names: list = [None] * 256
        code = 0
        for item in doc.resolve(enc.get("Differences")) or []:
            item = doc.resolve(item)
            if isinstance(item, (int, float)) and not isinstance(item, bool):
                code = int(item)
            elif isinstance(item, Name):
                if 0 <= code < 256:
                    self.names[code] = str(item)
                code += 1

    def decode(self, s: bytes) -> list[Glyph]:
        return [Glyph(c, 1, self.names[c], self.widths[c]) for c in s]

    def proc(self, name):
        return self.doc.resolve(self.procs.get(name)) if name is not None else None


def load_font(doc, font: dict):
    """The font object of a font dictionary."""
    sub = str(doc.resolve(font.get("Subtype")) or "")
    if sub == "Type0":
        return Type0Font(doc, font)
    if sub == "Type3":
        return Type3Font(doc, font)
    if sub in ("TrueType", "Type1", "MMType1"):
        return SimpleFont(doc, font)
    raise unsupported(f"the font type {sub or 'unknown'}")
