"""PDF file layer: the lexer, the objects, the cross-reference table and the
stream filters (ISO 32000-1 §7).

The port's counterpart of what the JAX package gets from PyMuPDF's
``fitz.open`` (``spine_vision_tpu/io/pdf.py``); no PyMuPDF is imported.

- Objects: ``None``, ``bool``, ``int``, ``float``, strings as ``bytes``,
  names as :class:`Name`, arrays as ``list``, dictionaries as ``dict`` keyed
  by name, :class:`Stream` (its dictionary and raw bytes) and :class:`Ref`.
- Cross-reference: classic tables and xref streams (PDF 1.5, with object
  streams), incremental updates through ``/Prev`` (the newest entry wins).
  When ``startxref``, a table or an offset is wrong, the table is rebuilt by
  scanning the file for ``n g obj`` (the last definition of an object wins)
  and its trailers, as MuPDF repairs a file without a word.
- Filters: ``FlateDecode`` (PNG predictors 10-15 and the TIFF predictor 2),
  ``LZWDecode`` (``EarlyChange``), ``ASCIIHexDecode``, ``ASCII85Decode``,
  ``RunLengthDecode``. The image filters (``DCTDecode``, ``JPXDecode``,
  ``CCITTFaxDecode``) end a chain and are decoded by :func:`decode_image_filter`:
  DCT through ``io/jpeg.py``, JPX through ``io/jpeg2000.py``, CCITT Group 4
  (``K < 0``) through ``native.pdf_g4_decode`` (C++) or :func:`g4_decode_plain`.

Encrypted files, ``JBIG2Decode``, CCITT Group 3 (``K >= 0``), ``Crypt`` and
unknown filters raise ``NotImplementedError`` naming ROADMAP Queue 1 item 13.
A file that cannot be read at all raises :class:`PdfError`.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field

import numpy as np

UNSUPPORTED = "ROADMAP.md, Queue 1 item 13"


class PdfError(ValueError):
    """A file that is not a PDF or is damaged beyond repair."""


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"PDF: {what} is not rendered by the port ({UNSUPPORTED})")


class Name(str):
    """A PDF name (``/Foo``), distinct from a string (``bytes``)."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "/" + str(self)


@dataclass(frozen=True)
class Ref:
    num: int
    gen: int = 0


@dataclass
class Stream:
    dict: dict
    raw: bytes
    doc: "Document | None" = field(default=None, repr=False)

    def get(self, key: str, default=None):
        return self.dict.get(key, default)

    def data(self) -> bytes:
        """The stream's bytes through every filter but an image filter
        (which raises here: images go through :func:`decode_image_filter`)."""
        filters, parms = stream_filters(self)
        data = self.raw
        for name, parm in zip(filters, parms):
            if name in IMAGE_FILTERS:
                raise unsupported(f"{name} outside an image")
            data = apply_filter(name, data, parm)
        return data


class Keyword(str):
    """An operator or keyword of the lexer (``obj``, ``R``, ``Tj``...)."""

    __slots__ = ()


_WS = b" \t\n\r\f\x00"
_DELIM = b"()<>[]{}/%"
_REGULAR = re.compile(rb"[^ \t\n\r\f\x00()<>\[\]{}/%]+")
_NUMBER = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)$")
_INT = re.compile(rb"[+-]?\d+$")
_ESCAPES = {ord("n"): 10, ord("r"): 13, ord("t"): 9, ord("b"): 8, ord("f"): 12,
            ord("("): 40, ord(")"): 41, ord("\\"): 92}


class Lexer:
    """Tokens of a PDF byte string from ``pos``: objects for literals, a
    :class:`Keyword` for anything else, ``None`` at the end."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.n = len(data)

    def skip_ws(self) -> None:
        data, n, pos = self.data, self.n, self.pos
        while pos < n:
            c = data[pos]
            if c in _WS:
                pos += 1
            elif c == 0x25:  # % comment to the end of the line
                while pos < n and data[pos] not in b"\r\n":
                    pos += 1
            else:
                break
        self.pos = pos

    def token(self):
        self.skip_ws()
        if self.pos >= self.n:
            return None
        data = self.data
        c = data[self.pos]
        if c == 0x2F:  # /Name
            m = _REGULAR.match(data, self.pos + 1)
            raw = m.group() if m else b""
            self.pos += 1 + len(raw)
            if b"#" in raw:
                raw = re.sub(rb"#([0-9A-Fa-f]{2})", lambda g: bytes([int(g.group(1), 16)]), raw)
            return Name(raw.decode("latin-1"))
        if c == 0x28:  # (string)
            return self._literal()
        if c == 0x3C:
            if self.pos + 1 < self.n and data[self.pos + 1] == 0x3C:
                self.pos += 2
                return Keyword("<<")
            end = data.find(b">", self.pos)
            if end < 0:
                end = self.n
            hexes = re.sub(rb"[^0-9A-Fa-f]", b"", data[self.pos + 1:end])
            self.pos = end + 1
            if len(hexes) % 2:
                hexes += b"0"
            return bytes.fromhex(hexes.decode())
        if c == 0x3E:
            if self.pos + 1 < self.n and data[self.pos + 1] == 0x3E:
                self.pos += 2
                return Keyword(">>")
            self.pos += 1
            return Keyword(">")
        if c in b"[]{}":
            self.pos += 1
            return Keyword(chr(c))
        if c == 0x29:  # a stray ')'
            self.pos += 1
            return Keyword(")")
        m = _REGULAR.match(data, self.pos)
        raw = m.group()
        self.pos += len(raw)
        if _NUMBER.match(raw):
            if _INT.match(raw):
                return int(raw)
            return float(raw)
        if raw == b"true":
            return True
        if raw == b"false":
            return False
        if raw == b"null":
            return None
        return Keyword(raw.decode("latin-1"))

    def _literal(self) -> bytes:
        data, n = self.data, self.n
        pos = self.pos + 1
        depth = 1
        out = bytearray()
        while pos < n:
            c = data[pos]
            if c == 0x5C:  # backslash
                pos += 1
                if pos >= n:
                    break
                e = data[pos]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    pos += 1
                elif 0x30 <= e <= 0x37:
                    m = re.match(rb"[0-7]{1,3}", data[pos:pos + 3])
                    out.append(int(m.group(), 8) & 0xFF)
                    pos += len(m.group())
                elif e == 0x0D:  # line continuation
                    pos += 2 if pos + 1 < n and data[pos + 1] == 0x0A else 1
                elif e == 0x0A:
                    pos += 1
                else:
                    out.append(e)
                    pos += 1
                continue
            if c == 0x28:
                depth += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    pos += 1
                    break
            out.append(c)
            pos += 1
        self.pos = pos
        return bytes(out)


class _Parser:
    """Objects over a :class:`Lexer`, with ``n g R`` references."""

    def __init__(self, lexer: Lexer):
        self.lex = lexer
        self.pending: list = []

    def _next(self):
        if self.pending:
            return self.pending.pop()
        return self.lex.token()

    def _push(self, tok) -> None:
        self.pending.append(tok)

    def parse(self, tok=None):
        if tok is None:
            tok = self._next()
        if isinstance(tok, Keyword):
            if tok == "[":
                out = []
                while True:
                    t = self._next()
                    if t is None or t == "]":
                        return out
                    out.append(self.parse(t))
            if tok == "<<":
                out = {}
                while True:
                    t = self._next()
                    if t is None or t == ">>":
                        return out
                    if not isinstance(t, Name):
                        continue  # MuPDF skips a malformed key
                    value = self._next()
                    if value == ">>":
                        out[t] = None
                        return out
                    out[str(t)] = self.parse(value)
            return tok
        if isinstance(tok, int) and not isinstance(tok, bool):
            t2 = self._next()
            if isinstance(t2, int) and not isinstance(t2, bool):
                t3 = self._next()
                if t3 == "R":
                    return Ref(tok, t2)
                self._push(t3)
            self._push(t2)
        return tok


_OBJ_HEADER = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")
_XREF_ROW = re.compile(rb"(\d{10})\s(\d{5})\s([nf])")


class Document:
    """A PDF file: its objects on demand, its trailer and its pages."""

    def __init__(self, data: bytes):
        if b"%PDF-" not in data[:1024]:
            raise PdfError("Not a PDF file (no %PDF- header)")
        self.data = data
        self.xref: dict[int, tuple] = {}  # num -> ("n", offset, gen) | ("s", objstm, index)
        self.trailer: dict = {}
        self.cache: dict[int, object] = {}
        self.objstm_cache: dict[int, dict[int, object]] = {}
        self.repaired = False
        try:
            self._load_xref()
            if "Root" not in self.trailer:
                raise PdfError("no /Root in the trailer")
            self.resolve(self.trailer["Root"])["Pages"]
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 — rebuild the table as MuPDF does
            self._repair()
        if "Encrypt" in self.trailer and self.trailer["Encrypt"] is not None:
            raise unsupported("an encrypted file")

    # -- cross-reference --------------------------------------------------
    def _load_xref(self) -> None:
        at = self.data.rfind(b"startxref")
        if at < 0:
            raise PdfError("no startxref")
        lex = Lexer(self.data, at + len(b"startxref"))
        offset = lex.token()
        if not isinstance(offset, int):
            raise PdfError("bad startxref")
        seen = set()
        first = True
        while offset is not None and offset not in seen:
            seen.add(offset)
            trailer = self._read_section(offset)
            if first:
                self.trailer = dict(trailer)
                first = False
            else:
                for k, v in trailer.items():
                    self.trailer.setdefault(k, v)
            if "XRefStm" in trailer:  # a hybrid file's xref stream
                self._read_section(int(trailer["XRefStm"]))
            prev = trailer.get("Prev")
            offset = int(prev) if isinstance(prev, (int, float)) else None

    def _read_section(self, offset: int) -> dict:
        lex = Lexer(self.data, offset)
        lex.skip_ws()
        if self.data.startswith(b"xref", lex.pos):
            return self._read_table(lex.pos + 4)
        m = _OBJ_HEADER.match(self.data, lex.pos)
        if not m:
            raise PdfError(f"no xref at {offset}")
        stream = self._parse_indirect(lex.pos)[0]
        if not isinstance(stream, Stream) or stream.get("Type") != "XRef":
            raise PdfError(f"no xref stream at {offset}")
        self._read_xref_stream(stream)
        return stream.dict

    def _read_table(self, pos: int) -> dict:
        lex = Lexer(self.data, pos)
        while True:
            lex.skip_ws()
            if self.data.startswith(b"trailer", lex.pos):
                lex.pos += len(b"trailer")
                trailer = _Parser(lex).parse()
                if not isinstance(trailer, dict):
                    raise PdfError("bad trailer")
                return trailer
            start, count = lex.token(), lex.token()
            if not isinstance(start, int) or not isinstance(count, int):
                raise PdfError("bad xref subsection")
            lex.skip_ws()
            for i in range(count):
                m = _XREF_ROW.match(self.data, lex.pos)
                if not m:
                    raise PdfError("bad xref row")
                lex.pos = m.end()
                lex.skip_ws()
                num = start + i
                if num in self.xref:
                    continue
                if m.group(3) == b"n":
                    self.xref[num] = ("n", int(m.group(1)), int(m.group(2)))
                else:
                    self.xref[num] = ("f", 0, 0)

    def _read_xref_stream(self, stream: Stream) -> None:
        w = [int(v) for v in self.resolve(stream.get("W"))]
        size = int(self.resolve(stream.get("Size")))
        index = self.resolve(stream.get("Index")) or [0, size]
        data = stream.data()
        row = sum(w)
        pos = 0
        for s, c in zip(index[0::2], index[1::2]):
            for num in range(int(s), int(s) + int(c)):
                if pos + row > len(data):
                    raise PdfError("truncated xref stream")
                fields = []
                for width in w:
                    v = int.from_bytes(data[pos:pos + width], "big") if width else None
                    pos += width
                    fields.append(v)
                kind = 1 if fields[0] is None else fields[0]
                if num in self.xref:
                    continue
                if kind == 1:
                    self.xref[num] = ("n", fields[1], fields[2] or 0)
                elif kind == 2:
                    self.xref[num] = ("s", fields[1], fields[2] or 0)
                else:
                    self.xref[num] = ("f", 0, 0)

    def _repair(self) -> None:
        """Rebuild the table from every ``n g obj`` in the file; the trailer
        from the last ``trailer`` dictionary or xref stream, else the
        catalog found among the objects."""
        self.repaired = True
        self.xref = {}
        self.cache = {}
        self.objstm_cache = {}
        self.trailer = {}
        data = self.data
        for m in _OBJ_HEADER.finditer(data):
            if m.start() > 0 and data[m.start() - 1] not in _WS + _DELIM:
                continue
            self.xref[int(m.group(1))] = ("n", m.start(), int(m.group(2)))
        for m in re.finditer(rb"trailer\s*<<", data):
            try:
                t = _Parser(Lexer(data, m.start() + len(b"trailer"))).parse()
            except Exception:  # noqa: BLE001
                continue
            if isinstance(t, dict):
                self.trailer.update(t)
        for num in list(self.xref):
            try:
                obj = self.get(num)
            except NotImplementedError:
                raise
            except Exception:  # noqa: BLE001
                continue
            if isinstance(obj, Stream) and obj.get("Type") == "ObjStm":
                self._index_objstm(num)
            if isinstance(obj, Stream) and obj.get("Type") == "XRef":
                for key in ("Root", "Info", "Encrypt", "ID"):
                    if key in obj.dict:
                        self.trailer.setdefault(key, obj.dict[key])
        if "Root" not in self.trailer or not self._is_catalog(self.trailer["Root"]):
            for num in sorted(self.xref):
                try:
                    obj = self.get(num)
                except Exception:  # noqa: BLE001
                    continue
                if isinstance(obj, dict) and obj.get("Type") == "Catalog":
                    self.trailer["Root"] = Ref(num, self.xref[num][2])
        if "Root" not in self.trailer:
            raise PdfError("damaged beyond repair: no catalog")

    def _is_catalog(self, ref) -> bool:
        try:
            return isinstance(self.resolve(ref), dict)
        except Exception:  # noqa: BLE001
            return False

    def _index_objstm(self, num: int) -> None:
        for n in self._objstm(num):
            if n not in self.xref or self.xref[n][0] != "n":
                self.xref[n] = ("s", num, -1)

    # -- objects ------------------------------------------------------------
    def _parse_indirect(self, pos: int) -> tuple:
        m = _OBJ_HEADER.match(self.data, pos)
        if not m:
            raise PdfError(f"no object at {pos}")
        lex = Lexer(self.data, m.end())
        parser = _Parser(lex)
        obj = parser.parse()
        tok = parser._next()
        if tok == "stream":
            start = lex.pos
            if self.data[start:start + 2] == b"\r\n":
                start += 2
            elif self.data[start:start + 1] in (b"\n", b"\r"):
                start += 1
            length = obj.get("Length") if isinstance(obj, dict) else None
            raw = None
            if isinstance(length, Ref):
                try:
                    length = self.resolve(length)
                except Exception:  # noqa: BLE001
                    length = None
            if isinstance(length, int) and length >= 0:
                end = start + length
                tail = self.data[end:end + 20].lstrip(_WS)
                if tail.startswith(b"endstream"):
                    raw = self.data[start:end]
            if raw is None:  # a wrong /Length: up to endstream, as MuPDF reads it
                end = self.data.find(b"endstream", start)
                if end < 0:
                    raise PdfError("unterminated stream")
                raw = self.data[start:end]
                if raw.endswith(b"\r\n"):
                    raw = raw[:-2]
                elif raw.endswith((b"\n", b"\r")):
                    raw = raw[:-1]
            obj = Stream(obj, raw, self)
        return obj, (int(m.group(1)), int(m.group(2)))

    def get(self, num: int):
        if num in self.cache:
            return self.cache[num]
        entry = self.xref.get(num)
        if entry is None or entry[0] == "f":
            return None
        if entry[0] == "n":
            try:
                obj, (n, _) = self._parse_indirect(entry[1])
                if n != num:
                    raise PdfError(f"object {num} is not at its offset")
            except PdfError:
                if self.repaired:
                    raise
                self._repair()
                return self.get(num)
        else:
            objs = self._objstm(entry[1])
            obj = objs.get(num)
        self.cache[num] = obj
        return obj

    def _objstm(self, num: int) -> dict:
        if num in self.objstm_cache:
            return self.objstm_cache[num]
        self.objstm_cache[num] = {}
        stream = self.get(num)
        if not isinstance(stream, Stream):
            raise PdfError(f"object stream {num} is not a stream")
        data = stream.data()
        n, first = int(self.resolve(stream.get("N"))), int(self.resolve(stream.get("First")))
        lex = Lexer(data)
        pairs = [(lex.token(), lex.token()) for _ in range(n)]
        out = {}
        for objnum, off in pairs:
            if not isinstance(objnum, int) or not isinstance(off, int):
                break
            out[objnum] = _Parser(Lexer(data, first + off)).parse()
        self.objstm_cache[num] = out
        return out

    def resolve(self, obj, depth: int = 0):
        while isinstance(obj, Ref):
            if depth > 32:
                raise PdfError("reference loop")
            obj = self.get(obj.num)
            depth += 1
        return obj

    # -- pages ----------------------------------------------------------------
    def pages(self) -> list[dict]:
        """Each page's dictionary with its inherited attributes filled in
        (``Resources``, ``MediaBox``, ``CropBox``, ``Rotate``)."""
        root = self.resolve(self.trailer["Root"])
        out: list[dict] = []
        seen: set = set()

        def walk(node_ref, inherited: dict) -> None:
            key = node_ref.num if isinstance(node_ref, Ref) else id(node_ref)
            if key in seen:
                return
            seen.add(key)
            node = self.resolve(node_ref)
            if not isinstance(node, dict):
                return
            attrs = dict(inherited)
            for k in ("Resources", "MediaBox", "CropBox", "Rotate"):
                if k in node:
                    attrs[k] = node[k]
            kids = self.resolve(node.get("Kids"))
            if node.get("Type") == "Pages" or (node.get("Type") != "Page" and kids is not None):
                for kid in kids or []:
                    walk(kid, attrs)
            else:
                page = dict(node)
                page.update({k: v for k, v in attrs.items() if k not in node})
                out.append(page)

        walk(root.get("Pages"), {})
        return out


# -- filters ---------------------------------------------------------------------
IMAGE_FILTERS = {"DCTDecode", "JPXDecode", "CCITTFaxDecode", "JBIG2Decode"}
_ABBREVIATIONS = {"AHx": "ASCIIHexDecode", "A85": "ASCII85Decode", "LZW": "LZWDecode",
                  "Fl": "FlateDecode", "RL": "RunLengthDecode", "CCF": "CCITTFaxDecode",
                  "DCT": "DCTDecode"}


def stream_filters(stream: Stream) -> tuple[list[str], list[dict]]:
    doc = stream.doc
    resolve = doc.resolve if doc is not None else (lambda o: o)
    filters = resolve(stream.get("Filter", stream.get("F")))
    parms = resolve(stream.get("DecodeParms", stream.get("DP")))
    if filters is None:
        return [], []
    if not isinstance(filters, list):
        filters, parms = [filters], [parms]
    elif not isinstance(parms, list):
        parms = [parms] * len(filters)
    names = [_ABBREVIATIONS.get(str(resolve(f)), str(resolve(f))) for f in filters]
    parms = [resolve(p) if isinstance(resolve(p), dict) else {} for p in parms]
    parms += [{}] * (len(names) - len(parms))
    return names, parms


def apply_filter(name: str, data: bytes, parm: dict) -> bytes:
    if name == "FlateDecode":
        return _predict(_inflate(data), parm)
    if name == "LZWDecode":
        return _predict(lzw_decode(data, int(parm.get("EarlyChange", 1))), parm)
    if name == "ASCIIHexDecode":
        return ascii_hex_decode(data)
    if name == "ASCII85Decode":
        return ascii85_decode(data)
    if name == "RunLengthDecode":
        return run_length_decode(data)
    if name == "Crypt":
        raise unsupported("the Crypt filter")
    raise unsupported(f"the {name} filter")


def _inflate(data: bytes) -> bytes:
    """zlib (or raw deflate) data, as much as decodes: MuPDF keeps the bytes
    before a broken or truncated tail."""
    for wbits in (15, -15):
        d = zlib.decompressobj(wbits)
        try:
            return d.decompress(data) + d.flush()
        except zlib.error:
            if wbits == -15:
                break
    d = zlib.decompressobj(15)
    out = bytearray()
    for i in range(0, len(data), 64):
        try:
            out += d.decompress(data[i:i + 64])
        except zlib.error:
            break
    return bytes(out)


def _predict(data: bytes, parm: dict) -> bytes:
    predictor = int(parm.get("Predictor", 1))
    if predictor == 1:
        return data
    colors = int(parm.get("Colors", 1))
    bpc = int(parm.get("BitsPerComponent", 8))
    columns = int(parm.get("Columns", 1))
    bpp = max(1, colors * bpc // 8)
    row = (colors * bpc * columns + 7) // 8
    if predictor == 2:
        if bpc != 8:
            raise unsupported(f"the TIFF predictor at {bpc} bits")
        arr = np.frombuffer(data[: len(data) // row * row], np.uint8).reshape(-1, row // colors, colors)
        return np.cumsum(arr, axis=1, dtype=np.uint8).tobytes()
    if predictor < 10:
        raise unsupported(f"predictor {predictor}")
    out = bytearray()
    prev = bytearray(row)
    stride = row + 1
    for start in range(0, len(data) - stride + 1 if len(data) >= stride else 0, stride):
        kind = data[start]
        cur = bytearray(data[start + 1:start + stride])
        if kind == 1:
            arr = np.frombuffer(bytes(cur) + bytes(-row % bpp), np.uint8).reshape(-1, bpp)
            cur = bytearray(np.cumsum(arr, axis=0, dtype=np.uint8).tobytes()[:row])
        elif kind == 2:
            cur = bytearray((np.frombuffer(cur, np.uint8) + np.frombuffer(prev, np.uint8)).tobytes())
        elif kind == 3:
            for i in range(row):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif kind == 4:
            for i in range(row):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        elif kind != 0:
            raise PdfError(f"bad PNG predictor row type {kind}")
        out += cur
        prev = cur
    return bytes(out)


def lzw_decode(data: bytes, early_change: int = 1) -> bytes:
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bits = 9
    buf = 0
    nbits = 0
    prev = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= bits:
            nbits -= bits
            code = (buf >> nbits) & ((1 << bits) - 1)
            buf &= (1 << nbits) - 1
            if code == 256:  # clear
                table = table[:258]
                bits = 9
                prev = None
                continue
            if code == 257:  # end of data
                return bytes(out)
            if prev is None:
                entry = table[code] if code < len(table) else b""
                out += entry
                prev = entry
                continue
            if code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise PdfError("bad LZW code")
            out += entry
            prev = entry
            nxt = len(table) + early_change
            bits = 9 if nxt < 512 else 10 if nxt < 1024 else 11 if nxt < 2048 else 12
    return bytes(out)


def ascii_hex_decode(data: bytes) -> bytes:
    end = data.find(b">")
    if end >= 0:
        data = data[:end]
    hexes = re.sub(rb"[^0-9A-Fa-f]", b"", data)
    if len(hexes) % 2:
        hexes += b"0"
    return bytes.fromhex(hexes.decode())


def ascii85_decode(data: bytes) -> bytes:
    data = re.sub(rb"\s", b"", data)
    if data.startswith(b"<~"):
        data = data[2:]
    end = data.find(b"~>")
    if end >= 0:
        data = data[:end]
    out = bytearray()
    group = []
    for c in data:
        if c == ord("z") and not group:
            out += b"\0\0\0\0"
            continue
        if not 33 <= c <= 117:
            raise PdfError("bad ASCII85 byte")
        group.append(c - 33)
        if len(group) == 5:
            v = 0
            for g in group:
                v = v * 85 + g
            out += (v & 0xFFFFFFFF).to_bytes(4, "big")
            group = []
    if group:
        n = len(group)
        group += [84] * (5 - n)
        v = 0
        for g in group:
            v = v * 85 + g
        out += (v & 0xFFFFFFFF).to_bytes(4, "big")[: n - 1]
    return bytes(out)


def run_length_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n == 128:
            break
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        else:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


# -- CCITT Group 4 (ITU-T T.6) --------------------------------------------------------
# Run-length codes of ITU-T T.4 (tables 2 and 3): code bits -> run length.
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
    "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
    "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
    "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
    "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
    "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
    "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
    "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
    "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
    "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
    "0000001011011 0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 "
               "000000011110 000000011111").split()
# Two-dimensional mode codes (T.4 table 4): P, H, V0, VR1-3, VL1-3.
G4_PASS, G4_HORIZ, G4_EXT = 8, 9, 10  # V-k..V+k are 0..6 (offset k + 3)
_MODES = {"0001": G4_PASS, "001": G4_HORIZ, "1": 3, "011": 4, "000011": 5, "0000011": 6,
          "010": 2, "000010": 1, "0000010": 0, "0000001": G4_EXT}
G4_PEEK = 13


def _lut(codes: dict, peek: int) -> np.ndarray:
    """A ``peek``-bit lookup table: entry ``(length << 16) | value``, 0 for no code."""
    lut = np.zeros(1 << peek, np.int32)
    for bits, value in codes.items():
        n = len(bits)
        base = int(bits, 2) << (peek - n)
        lut[base:base + (1 << (peek - n))] = (n << 16) | value
    return lut


def g4_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The white-run, black-run and mode lookup tables (13-bit peeks) that
    both G4 decoders read."""
    white = {c: i for i, c in enumerate(_WHITE_TERM)}
    white.update({c: 64 * (i + 1) for i, c in enumerate(_WHITE_MAKEUP)})
    black = {c: i for i, c in enumerate(_BLACK_TERM)}
    black.update({c: 64 * (i + 1) for i, c in enumerate(_BLACK_MAKEUP)})
    for i, c in enumerate(_EXT_MAKEUP):
        white[c] = black[c] = 1792 + 64 * i
    return _lut(white, G4_PEEK), _lut(black, G4_PEEK), _lut(_MODES, G4_PEEK)


class _Bits:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.end = len(data) * 8

    def peek(self, n: int) -> int:
        v = 0
        for i in range(n):
            p = self.pos + i
            bit = (self.data[p >> 3] >> (7 - (p & 7))) & 1 if p < self.end else 0
            v = (v << 1) | bit
        return v


def g4_decode_plain(data: bytes, columns: int, rows: int, byte_align: bool = False) -> np.ndarray:
    """Decode a CCITT Group 4 stream: uint8 ``[rows, columns]``, 1 where a
    pixel is black in the CCITT sense. ``rows`` 0 decodes to the end of the
    data (EOFB). The plain version of ``native.pdf_g4_decode``, bit for bit."""
    white, black, modes = g4_tables()
    bits = _Bits(data)
    out_rows = []
    ref = [columns] * 3
    while rows <= 0 or len(out_rows) < rows:
        if byte_align and bits.pos & 7:
            bits.pos += 8 - (bits.pos & 7)
        if bits.pos >= bits.end:
            break
        if bits.peek(12) == 1:  # EOL: EOFB ends the data
            break
        cur: list[int] = []
        a0, color = -1, 0
        i = 0  # index into ref of the b1 search
        bad = False
        while a0 < columns:
            # b1: the first changing element of ref right of a0 whose colour
            # differs from a0's (ref[even]: white->black, ref[odd]: black->white).
            while i > 0 and ref[i - 1] > a0:
                i -= 1
            while ref[i] <= a0 or (i & 1) != color:
                i += 1
            b1, b2 = ref[i], ref[i + 1]
            entry = int(modes[bits.peek(G4_PEEK)])
            if entry == 0:
                bad = True
                break
            bits.pos += entry >> 16
            mode = entry & 0xFFFF
            if mode == G4_PASS:
                a0 = b2
            elif mode == G4_HORIZ:
                start = max(a0, 0)
                runs = []
                for c in (color, 1 - color):
                    total = 0
                    table = white if c == 0 else black
                    while True:
                        e = int(table[bits.peek(G4_PEEK)])
                        if e == 0:
                            bad = True
                            break
                        bits.pos += e >> 16
                        total += e & 0xFFFF
                        if (e & 0xFFFF) < 64:
                            break
                    if bad:
                        break
                    runs.append(total)
                if bad:
                    break
                a1 = min(start + runs[0], columns)
                a2 = min(a1 + runs[1], columns)
                cur += [a1, a2]
                a0 = a2
            elif mode == G4_EXT:
                raise unsupported("a CCITT extension code")
            else:
                a1 = b1 + mode - 3
                if a1 < 0 or a1 > columns or (cur and a1 < cur[-1]):
                    bad = True
                    break
                cur.append(a1)
                a0 = a1
                color = 1 - color
            if bits.pos > bits.end + 24:
                bad = True
                break
        if bad:
            raise PdfError(f"corrupt CCITT G4 data at row {len(out_rows)}")
        row = np.zeros(columns, np.uint8)
        for k in range(0, len(cur) - 1, 2):
            row[cur[k]:cur[k + 1]] = 1
        if len(cur) % 2:
            row[cur[-1]:] = 1
        out_rows.append(row)
        # The next reference line: equal neighbours (empty runs) dropped in
        # pairs, so ref[even] stays a white-to-black change.
        clean: list[int] = []
        for c in cur:
            if c >= columns:
                break
            if clean and clean[-1] == c:
                clean.pop()
            else:
                clean.append(c)
        ref = clean + [columns] * 3
    if rows > 0 and len(out_rows) < rows:
        out_rows += [np.zeros(columns, np.uint8)] * (rows - len(out_rows))
    if not out_rows:
        return np.zeros((0, columns), np.uint8)
    return np.stack(out_rows)


def ccitt_decode(data: bytes, parm: dict, plain: bool = False, height: int = 0) -> np.ndarray:
    """CCITTFaxDecode to samples: uint8 ``[rows, columns]`` of 0 and 1 (the
    filter's output bits, ``BlackIs1`` applied); ``height`` (the image's)
    when ``/Rows`` is absent."""
    k = int(parm.get("K", 0))
    if k >= 0:
        raise unsupported("CCITT Group 3 (K >= 0)")
    columns = int(parm.get("Columns", 1728))
    rows = int(parm.get("Rows", 0)) or height
    align = bool(parm.get("EncodedByteAlign", False))
    if plain:
        black = g4_decode_plain(data, columns, rows, align)
    else:
        from spine_vision_torch import native

        black = native.pdf_g4_decode(data, columns, rows, align)
    return black if parm.get("BlackIs1", False) else 1 - black


def decode_image_filter(name: str, data: bytes, parm: dict, plain: bool = False,
                        height: int = 0):
    """The last filter of an image: DCT -> uint8 ``[H, W]`` or ``[H, W, 3]``;
    JPX -> Pillow's modes (``io/jpeg2000.py``); CCITT -> 0/1 samples."""
    if name == "DCTDecode":
        from spine_vision_torch.io import jpeg

        return jpeg.decode_jpeg(data, plain=plain)
    if name == "JPXDecode":
        from spine_vision_torch.io import jpeg2000

        return jpeg2000.decode_jpeg2000(data, plain=plain)
    if name == "CCITTFaxDecode":
        return ccitt_decode(data, parm, plain=plain, height=height)
    raise unsupported(f"the {name} filter")


_INLINE_KEYS = {"BPC": "BitsPerComponent", "CS": "ColorSpace", "D": "Decode",
                "DP": "DecodeParms", "F": "Filter", "H": "Height", "W": "Width",
                "IM": "ImageMask", "I": "Interpolate", "L": "Length"}


def _inline_image(lex: Lexer, parser: _Parser) -> Stream:
    """``BI`` ... ``ID`` data ``EI`` as a stream: the dictionary (keys
    expanded) and the raw data, whose end is ``/L`` when given, else the
    first ``EI`` between white space."""
    d: dict = {}
    while True:
        tok = parser._next()
        if tok is None:
            raise PdfError("unterminated inline image")
        if tok == "ID":
            break
        if isinstance(tok, Name):
            d[_INLINE_KEYS.get(str(tok), str(tok))] = parser.parse()
    data = lex.data
    start = lex.pos + 1  # one white-space byte after ID
    length = d.get("Length")
    if isinstance(length, int):
        end = start + length
    else:
        m = re.compile(rb"[\x00\t\n\r\f ]EI(?=[\x00\t\n\r\f ]|$)").search(data, start)
        end = m.start() if m else len(data)
    lex.pos = end
    tok = lex.token()
    if tok != "EI":  # /L pointed short of EI: scan on
        m = re.compile(rb"EI(?=[\x00\t\n\r\f ]|$)").search(data, end)
        lex.pos = m.end() if m else len(data)
    return Stream(d, data[start:end])


def content_ops(data: bytes):
    """A content stream as ``(operator, operands)`` pairs; an inline image is
    the operator ``BI`` with its :class:`Stream` as the one operand."""
    lex = Lexer(data)
    parser = _Parser(lex)
    args: list = []
    while True:
        tok = parser._next()
        if tok is None:
            return
        if isinstance(tok, Keyword):
            if tok in ("[", "<<"):
                args.append(parser.parse(tok))
                continue
            if tok == "BI":
                yield "BI", [_inline_image(lex, parser)]
                args = []
                continue
            yield str(tok), args
            args = []
        else:
            args.append(tok)
