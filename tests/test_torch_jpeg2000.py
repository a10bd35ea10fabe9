"""``spine_vision_torch/io/jpeg2000.py`` against Pillow and the JAX package.

The port decodes JPEG 2000 where the JAX package calls
``np.asarray(Image.open(f))`` (DICOM .90/.91 frames, raster files). Every
grid case encodes a seeded image with Pillow (12.1.0, OpenJPEG 2.5.4) and
holds the port's decode to Pillow's bit for bit: the reversible 5/3 path
and the irreversible 9/7 path alike (the 9/7 arithmetic follows OpenJPEG's
float32 order, so no sample differs; the tests assert that). The C++ tier-1
and its plain Python version agree on every code-block, corrupt ones
included. The committed fixtures (``tests/fixtures/torch_jpeg2000``) are
held to the record of Pillow's decodes that ``generate.py`` wrote.
"""

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fixtures.torch_jpeg2000.generate import encode_12_bit, to_12_bit
from spine_vision_torch import native
from spine_vision_torch.io import jpeg as tjpeg
from spine_vision_torch.io import jpeg2000 as tj

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_jpeg2000"
RECORD = json.loads((FIXTURES / "record.json").read_text())


def _image(shape, seed, top=255, dtype=np.uint8):
    """A smooth image with noise (real image content, not pure noise)."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    n = shape[2] if len(shape) == 3 else 1
    planes = [top / 2 + top * 0.4 * np.sin(x / (3 + k) + y / (5 + k))
              + rng.normal(0, top * 0.08, (h, w)) for k in range(n)]
    img = np.clip(np.stack(planes, -1), 0, top).astype(dtype)
    return img if len(shape) == 3 else img[..., 0]


def _encode(img: np.ndarray, mode=None, jp2=False, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG2000", no_jp2=not jp2, **kw)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_matches_pillow(data: bytes, plain: bool = False) -> None:
    want = _pillow(data)
    for p in (False, True) if plain else (False,):
        got = tj.decode_jpeg2000(data, plain=p)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (17, 9), (37, 53), (128, 128)])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_sizes_match_pillow(mode, size, irreversible):
    shape = size if mode == "L" else (*size, 3)
    data = _encode(_image(shape, size[0] + size[1]), irreversible=irreversible)
    _assert_matches_pillow(data, plain=size[0] * size[1] <= 17 * 9)


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("resolutions", [1, 2, 3, 4, 5, 6])
def test_resolutions(resolutions, irreversible):
    data = _encode(_image((37, 53), resolutions), irreversible=irreversible,
                   num_resolutions=resolutions)
    _assert_matches_pillow(data, plain=resolutions == 3)


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("codeblock", [(4, 4), (8, 4), (4, 16), (16, 16), (32, 8), (64, 64),
                                       (64, 16)])
def test_codeblock_sizes(codeblock, irreversible):
    data = _encode(_image((64, 80), 3), irreversible=irreversible, codeblock_size=codeblock)
    _assert_matches_pillow(data)


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("progression", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("precinct", [(16, 16), (32, 32), (64, 32)])
def test_precincts_and_progressions(precinct, progression, irreversible):
    # Pillow halves the precincts a level down: 16 x 16 over 6 resolutions
    # reaches 1 x 1, which OpenJPEG refuses (test_malformed_streams...).
    small = precinct == (16, 16)
    data = _encode(_image((37, 53, 3), 4), irreversible=irreversible, precinct_size=precinct,
                   progression=progression, codeblock_size=(4, 4) if small else (8, 8),
                   num_resolutions=3 if small else 6,
                   quality_layers=[30, 10, 3] if irreversible else None)
    assert data.count(b"\xff\x52") == 1
    _assert_matches_pillow(data, plain=precinct == (16, 16) and progression == "CPRL")


@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("progression", ["LRCP", "RPCL", "CPRL"])
@pytest.mark.parametrize("tiles", [((16, 16), (0, 0), None), ((16, 16), (3, 5), (4, 7)),
                                   ((32, 8), (0, 0), (5, 2)), ((20, 24), (1, 1), (1, 1))])
def test_tiles_and_offsets(tiles, progression, irreversible):
    size, tile_offset, offset = tiles
    kw = {"offset": offset} if offset else {}
    data = _encode(_image((37, 53), 5), irreversible=irreversible, progression=progression,
                   tile_size=size, tile_offset=tile_offset, **kw)
    _assert_matches_pillow(data)


@pytest.mark.parametrize("plt", [False, True])
@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("layers", [[40, 20, 10], [20], [5, 2, 1]])
def test_quality_layers(layers, irreversible, plt):
    data = _encode(_image((37, 53, 3), 6), irreversible=irreversible, quality_layers=layers,
                   plt=plt)
    assert b"\xff\x58" in data or not plt
    _assert_matches_pillow(data)


@pytest.mark.parametrize("jp2", [False, True])
@pytest.mark.parametrize("mct", [0, 1])
@pytest.mark.parametrize("irreversible", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_modes(mode, irreversible, mct, jp2):
    n = len(mode)
    img = _image((37, 53) if n == 1 else (37, 53, n), 7)
    data = _encode(img, mode, jp2=jp2, irreversible=irreversible, mct=mct)
    assert tj.is_jpeg2000(data)
    _assert_matches_pillow(data)
    # Pillow's convert("RGB") of each mode, as models/inference.py reads it.
    np.testing.assert_array_equal(tj.to_rgb(tj.decode_jpeg2000(data)),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("jp2", [False, True])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("irreversible", [False, True])
def test_sixteen_bit_and_signed(irreversible, signed, jp2):
    """I;16 at full range and at 12-bit values; signed data comes back as
    uint16 with Pillow's 2**15 offset added."""
    for top in (65535, 4000):
        img = _image((37, 53), top % 97, top, np.uint16)
        data = _encode(img, jp2=jp2, irreversible=irreversible, signed=signed)
        _assert_matches_pillow(data)
        got = tj.decode_jpeg2000(data)
        assert got.dtype == np.uint16
        if not irreversible and not signed:
            np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(tj.to_rgb(got),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    data = _encode(_image((17, 9), 1), signed=True, irreversible=irreversible)
    _assert_matches_pillow(data)


@pytest.mark.parametrize("irreversible", [False, True])
def test_twelve_bit_stream_decodes_shifted(irreversible):
    """A 12-bit stream (Pillow writes 8 or 16 bits only: the SIZ/QCD edit)
    decodes, as in Pillow, to ``x << 4`` in I;16."""
    img = _image((37, 53), 12, 4093, np.uint16)
    kw = {"irreversible": True, "quality_layers": [20]} if irreversible else {}
    data = encode_12_bit(img, **kw)
    _assert_matches_pillow(data, plain=True)
    if not irreversible:
        np.testing.assert_array_equal(tj.decode_jpeg2000(data), img.astype(np.uint16) << 4)
    with pytest.raises(ValueError, match="Ssiz"):
        to_12_bit(data)


def test_sycc_jp2_converts_with_pillow_tables():
    img = _image((37, 53, 3), 13)
    data = bytearray(_encode(img, jp2=True))
    at = data.index(b"colr")
    assert struct.unpack_from(">I", data, at + 7)[0] == 16
    struct.pack_into(">I", data, at + 7, 18)  # sYCC
    _assert_matches_pillow(bytes(data))


def test_tile_parts_split_anywhere():
    """Several tile-parts a tile: their bodies concatenate."""
    data = _encode(_image((37, 53), 14), tile_size=(32, 32), irreversible=True)
    want = _pillow(data)
    cs = bytearray(data)
    sot = cs.index(b"\xff\x90")
    psot = struct.unpack_from(">I", cs, sot + 6)[0]
    sod = cs.index(b"\xff\x93", sot)
    cut = sod + 2 + (sot + psot - sod - 2) // 2
    first = cs[sot:cut]
    struct.pack_into(">IBB", first, 6, len(first), 0, 2)
    second = bytearray(b"\xff\x90\x00\x0a" + struct.pack(">HIBB", 0, 0, 1, 2) + b"\xff\x93"
                       + cs[cut:sot + psot])
    struct.pack_into(">I", second, 6, len(second))
    split = bytes(cs[:sot] + first + second + cs[sot + psot:])
    np.testing.assert_array_equal(tj.decode_jpeg2000(split), want)
    np.testing.assert_array_equal(_pillow(split), want)


def _capture_blocks(data: bytes, monkeypatch) -> list:
    calls = []
    inner = tj._t1_decode

    def spy(raw, blocks, total, plain):
        calls.append((raw.copy(), blocks.copy(), total))
        return inner(raw, blocks, total, plain)

    monkeypatch.setattr(tj, "_t1_decode", spy)
    tj.decode_jpeg2000(data)
    monkeypatch.setattr(tj, "_t1_decode", inner)
    return calls


@pytest.mark.parametrize("corrupt", [False, True])
def test_native_tier1_matches_plain_on_every_codeblock(monkeypatch, corrupt):
    """The C++ tier-1 and the Python version on every code-block of a 5/3
    and a 9/7 stream (all four orientations, several passes), and with the
    code-blocks' bytes flipped at random (corrupt data)."""
    rng = np.random.default_rng(15)
    n_blocks = 0
    for kw in ({"codeblock_size": (8, 8)}, {"codeblock_size": (4, 8), "irreversible": True}):
        data = _encode(_image((19, 23), 16), **kw)
        for raw, blocks, total in _capture_blocks(data, monkeypatch):
            if corrupt:
                raw = raw.copy()
                flips = rng.integers(0, raw.size, max(1, raw.size // 8))
                raw[flips] ^= rng.integers(1, 256, flips.size).astype(np.uint8)
                blocks[:, 5] += rng.integers(0, 3, len(blocks)) * (blocks[:, 5] > 0)
                blocks[:, 6] += rng.integers(0, 4, len(blocks))
            got = native.j2k_t1_decode(raw, blocks, total)
            for off, length, w, h, orient, nbps, passes, at in blocks.tolist():
                want = tj._t1_decode_block(raw[off:off + length].tobytes(), w, h, orient, nbps,
                                           passes)
                np.testing.assert_array_equal(got[at:at + w * h].reshape(h, w), want)
                n_blocks += 1
    assert n_blocks > 40
    # Random bytes as a whole code-block, each orientation.
    for orient in range(4):
        raw = rng.integers(0, 256, 40).astype(np.uint8)
        blocks = np.array([[0, 40, 7, 9, orient, 9, 25, 0]], np.int64)
        np.testing.assert_array_equal(
            native.j2k_t1_decode(raw, blocks, 63).reshape(9, 7),
            tj._t1_decode_block(raw.tobytes(), 7, 9, orient, 9, 25))


def _insert_after(data: bytes, marker: bytes, segment: bytes) -> bytes:
    at = data.index(marker)
    length = struct.unpack_from(">H", data, at + 2)[0]
    return data[:at + 2 + length] + segment + data[at + 2 + length:]


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    out = bytearray(data)
    out[data.index(marker) + offset] = value
    return bytes(out)


@pytest.mark.parametrize("case", ["poc", "rgn", "ppm", "ppt", "codeblock_style",
                                  "subsampled", "precision_24", "mct_2", "palette"])
def test_unsupported_streams_raise_item_13(case):
    data = _encode(_image((24, 24), 17))
    if case == "poc":
        data = _insert_after(data, b"\xff\x52", b"\xff\x5f\x00\x09" + bytes([0, 0, 0, 1, 5, 1, 1]))
    elif case == "rgn":
        data = _insert_after(data, b"\xff\x52", b"\xff\x5e\x00\x05\x00\x00\x02")
    elif case == "ppm":
        data = _insert_after(data, b"\xff\x52", b"\xff\x60\x00\x03\x00")
    elif case == "ppt":
        data = _insert_after(data, b"\xff\x90", b"\xff\x61\x00\x03\x00")
    elif case == "codeblock_style":
        data = _patched(data, b"\xff\x52", 12, 0x01)  # selective arithmetic bypass
    elif case == "subsampled":
        data = _patched(data, b"\xff\x51", 41, 2)  # XRsiz of component 0
    elif case == "precision_24":
        data = _patched(data, b"\xff\x51", 40, 23)
    elif case == "mct_2":
        data = _patched(data, b"\xff\x52", 8, 2)
    else:  # a JP2 palette
        jp2 = _encode(_image((24, 24), 17), jp2=True)
        at = jp2.index(b"colr") - 4
        box = struct.pack(">I4sHB", 15, b"pclr", 1, 1) + bytes([7, 9])
        jp2 = bytearray(jp2[:at] + box + jp2[at:])
        head = jp2.index(b"jp2h") - 4
        struct.pack_into(">I", jp2, head, struct.unpack_from(">I", jp2, head)[0] + len(box))
        data = bytes(jp2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        tj.decode_jpeg2000(data)


def test_malformed_streams_raise_an_oserror():
    data = _encode(_image((37, 53), 18), irreversible=True, quality_layers=[40, 10])
    tiny_precincts = _encode(_image((37, 53), 18), precinct_size=(16, 16))
    for bad in (data[:len(data) - 2], data[:len(data) // 2], data[:150], data[:20],
                b"\xff\x4f\xff\x51", b"not jpeg 2000", tiny_precincts):
        with pytest.raises(OSError):
            _pillow(bad)
        with pytest.raises(tj.Jpeg2000Error):
            tj.decode_jpeg2000(bad)
    assert tj.is_jpeg2000(data) and not tj.is_jpeg2000(b"\xff\xd8\xff\xe0")


def test_fixtures_match_the_record():
    """Every committed fixture decodes to the sha256 of Pillow's decode in
    the record, and Pillow still decodes each to it."""
    from fixtures.torch_jpeg2000 import generate

    assert RECORD["pillow"] == "12.1.0" and RECORD["openjpeg"] == "2.5.4"
    assert len(RECORD["files"]) == 2 * generate.SLICES + 3
    for name, entry in RECORD["files"].items():
        data = (FIXTURES / name).read_bytes()
        got = tj.decode_jpeg2000(data) if tj.is_jpeg2000(data) else tjpeg.decode_jpeg(data)
        for arr in (got, _pillow(data)):
            assert [list(arr.shape), str(arr.dtype)] == [entry["shape"], entry["dtype"]]
            assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"], name
    assert generate.mr_series(16, 0).shape == (17, 16, 16)
    assert RECORD["files"]["series90/slice_00.j2k"]["mode"] == "I;16"
    assert sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file()) < 2.5e6


def test_dicom_multiframe_and_fragments_match_jax(tmp_path):
    """.90 and .91 files of 3 frames: one fragment a frame, a frame split
    over two fragments with a Basic Offset Table; pixel_array and the
    series read equal the JAX package's."""
    from test_torch_io import _assert_same_image, _encapsulated, _image_module, _part10

    from spine_vision_torch import io as tio
    from spine_vision_torch.io import dicom as tdcm
    from spine_vision_tpu import io as jio
    from spine_vision_tpu.io import dicom as jdcm

    rng = np.random.default_rng(19)
    rows, cols = 24, 20
    for ts in ("1.2.840.10008.1.2.4.90", "1.2.840.10008.1.2.4.91"):
        kw = {"irreversible": True, "quality_layers": [20]} if ts.endswith("91") else {}
        frames = [encode_12_bit(rng.integers(0, 4096, (rows, cols)).astype(np.uint16), **kw)
                  for _ in range(3)]
        frames = [f + b"\x00" * (len(f) % 2) for f in frames]
        split = [part for f in frames for part in (f[:10], f[10:])]
        sizes = [len(f) + 16 for f in frames]
        bot = struct.pack("<3I", *np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        for name, frags, table in (("one", frames, b""), ("split", split, bot)):
            path = tmp_path / f"{ts[-2:]}_{name}.dcm"
            path.write_bytes(_part10(ts, _image_module(rows, cols, frames=3)
                                     + _encapsulated(frags, table)))
            got, want = tdcm.DicomFile(path).pixel_array(), jdcm.DicomFile(path).pixel_array()
            assert got.dtype == want.dtype == np.uint16 and got.shape == (3, rows, cols)
            np.testing.assert_array_equal(got, want)
        series = tmp_path / f"series{ts[-2:]}"
        series.mkdir()
        for k in range(3):
            module = _image_module(rows, cols).replace(b"1\\2\\3 ", f"1\\2\\{k + 3} ".encode())
            (series / f"{k}.dcm").write_bytes(_part10(ts, module + _encapsulated([frames[k]])))
        _assert_same_image(tio.read_medical_image(series), jio.read_medical_image(series))
    # Pillow opens a frame by its content: a JPEG under .91 decodes as JPEG,
    # kept in its mode (RGB here, no convert("L")) as the JAX package keeps it.
    buf = io.BytesIO()
    Image.fromarray(_image((rows, cols, 3), 20)).save(buf, "JPEG", quality=85)
    path = tmp_path / "jpeg_in_91.dcm"
    path.write_bytes(_part10("1.2.840.10008.1.2.4.91",
                             _image_module(rows, cols, bits=8) + _encapsulated([buf.getvalue()])))
    got, want = tdcm.DicomFile(path).pixel_array(), jdcm.DicomFile(path).pixel_array()
    assert got.shape == want.shape == (1, rows, cols, 3)
    np.testing.assert_array_equal(got, want)
