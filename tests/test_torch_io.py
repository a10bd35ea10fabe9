"""The port's volume I/O (``spine_vision_torch/io``) against the JAX
package's (``spine_vision_tpu/io``): the counterparts of ``tests/test_io.py``,
files crossing between the packages in every format and both directions,
and DICOM datasets of every kind the parser reads.

Every reader returns the same array as the JAX reader on the same file, bit
for bit and of the same dtype, with the same spacing, origin, direction and
metadata keys (equal: both packages parse the same text with the same
code). A port writer's file read by JAX equals the array written, and so
does a JAX writer's file read by the port.
"""

import struct
import zlib

import numpy as np
import pytest

from spine_vision_torch import io as tio
from spine_vision_torch.io import dicom as tdcm
from spine_vision_torch.io import dicom_write as tdw
from spine_vision_torch.io import pdf as tpdf
from spine_vision_torch.io.jpeg_lossless import encode_jpeg_lossless
from spine_vision_tpu import io as jio
from spine_vision_tpu.io import dicom as jdcm
from spine_vision_tpu.io import pdf as jpdf

OBLIQUE = np.array([[np.cos(0.0873), 0.0, -np.sin(0.0873)],
                    [0.0, 1.0, 0.0],
                    [np.sin(0.0873), 0.0, np.cos(0.0873)]])


def _assert_same_image(got, want):
    assert got.array.dtype == want.array.dtype
    np.testing.assert_array_equal(got.array, want.array)
    for name in ("spacing", "origin", "direction"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert set(got.metadata) == set(want.metadata)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_io.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [b"1 ", b"15", b"7", b"100 ", b"-3 ", struct.pack("<H", 513),
                                 b"", b"2.0", b"\xff\xfe\xfd"])
def test_decode_int_is_ascii(raw):
    assert tdcm._decode_int(raw, default=42) == jdcm._decode_int(raw, default=42)


def _element(group, elem, vr, value: bytes, little=True) -> bytes:
    e = "<" if little else ">"
    head = struct.pack(f"{e}HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"SQ", b"UN", b"UT"):
        return head + b"\x00\x00" + struct.pack(f"{e}I", len(value)) + value
    return head + struct.pack(f"{e}H", len(value)) + value


def _implicit(group, elem, value: bytes) -> bytes:
    return struct.pack("<HHI", group, elem, len(value)) + value


def _part10(ts: str, body: bytes) -> bytes:
    uid = ts.encode() + (b"\x00" if len(ts) % 2 else b"")
    return b"\x00" * 128 + b"DICM" + _element(0x0002, 0x0010, b"UI", uid) + body


def _write_minimal_dicom(path, instance_number: bytes, pixel_value: int = 7):
    rows, cols = 4, 6
    pixels = np.full((rows, cols), pixel_value, dtype=np.uint16).tobytes()
    body = b"".join([
        _element(0x0008, 0x0060, b"CS", b"MR"),
        _element(0x0020, 0x000E, b"UI", b"1.2.3\x00"),
        _element(0x0020, 0x0013, b"IS", instance_number),
        _element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _element(0x0028, 0x0030, b"DS", b"0.5\\0.5 "),
        _element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _element(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        _element(0x7FE0, 0x0010, b"OW", pixels),
    ])
    path.write_bytes(_part10("1.2.840.10008.1.2.1", body))


def test_minimal_dicom_parse_and_instance_sort(tmp_path):
    for i, token in enumerate((b"2 ", b"10", b"1 ")):
        _write_minimal_dicom(tmp_path / f"s{i}.dcm", token, pixel_value=i + 1)
    single = tdcm.DicomFile(tmp_path / "s0.dcm")
    assert (single.instance_number, single.rows, single.cols) == (2, 4, 6)
    assert single.pixel_array().shape == (4, 6)
    volume = tdcm.read_dicom_series(tmp_path)
    assert [int(volume.array[k, 0, 0]) for k in range(3)] == [3, 1, 2]
    _assert_same_image(volume, jdcm.read_dicom_series(tmp_path))


FORMATS = [".mha", ".mhd", ".nrrd", ".nii", ".nii.gz", "series", ".dcm"]
DTYPES = [np.int16, np.float32, np.uint8, np.uint16]


def _volume(suffix, dtype, rng, oblique):
    n = 1 if suffix == ".dcm" else 5
    if np.dtype(dtype).kind == "f":
        arr = rng.normal(0, 100, (n, 8, 6)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(max(info.min, -3000), min(info.max, 3000), (n, 8, 6)).astype(dtype)
    return arr, dict(spacing=(0.7, 0.9, 2.5), origin=(1.0, -2.0, 3.0),
                     direction=OBLIQUE if oblique else np.eye(3))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("suffix", FORMATS)
def test_files_cross_between_packages(tmp_path, suffix, writer):
    """Each format, written by one package, read by both: the array written
    bit for bit (DICOM stores integers only), and the two readers agree on
    every geometry field and the metadata keys. Compressed and raw bodies
    both, and an oblique direction."""
    rng = np.random.default_rng(len(suffix))
    for dtype in DTYPES:
        if suffix in ("series", ".dcm") and np.dtype(dtype).kind == "f":
            continue
        for compress, oblique in ((True, False), (False, True)):
            arr, geometry = _volume(suffix, dtype, rng, oblique)
            path = tmp_path / f"{writer}_{np.dtype(dtype).name}_{compress}{suffix}"
            if suffix == "series":
                path = path.with_suffix("")
            mod = tio if writer == "port" else jio
            mod.write_medical_image(mod.MedicalImage(array=arr, **geometry), path,
                                    use_compression=compress)
            got, want = tio.read_medical_image(path), jio.read_medical_image(path)
            _assert_same_image(got, want)
            want_dtype = (np.int16 if np.dtype(dtype).kind == "i" else np.uint16) if (
                suffix in ("series", ".dcm")) else dtype
            assert got.array.dtype == want_dtype
            np.testing.assert_array_equal(got.array, arr.astype(want_dtype))
            np.testing.assert_allclose(got.spacing[:2], geometry["spacing"][:2], rtol=1e-5)
            if suffix != ".dcm":
                np.testing.assert_allclose(got.spacing, geometry["spacing"], rtol=1e-5)
                np.testing.assert_allclose(got.origin, geometry["origin"], atol=1e-5)
                np.testing.assert_allclose(got.direction, geometry["direction"], atol=1e-5)


@pytest.mark.parametrize("suffix", [".mha", ".nrrd", ".nii.gz"])
def test_write_read_roundtrip(tmp_path, suffix):
    rng = np.random.default_rng(0)
    volume = rng.normal(0, 100, (5, 8, 6)).astype(np.float32)
    image = tio.MedicalImage(array=volume, spacing=(0.7, 0.9, 2.5), origin=(1.0, -2.0, 3.0))
    path = tmp_path / f"vol{suffix}"
    tio.write_medical_image(image, path)
    back = tio.read_medical_image(path)
    np.testing.assert_array_equal(back.array, volume)
    np.testing.assert_allclose(back.spacing, image.spacing, rtol=1e-5)
    _assert_same_image(back, jio.read_medical_image(path))


def test_jpeg_lossless_series_crosses_to_jax(tmp_path):
    """The port's JPEG Lossless SV1 series (an option the JAX writer lacks)
    reads in both packages as the array written."""
    rng = np.random.default_rng(5)
    for dtype in (np.int16, np.uint16):
        arr = rng.integers(-2000 if dtype == np.int16 else 0, 4000, (3, 12, 10)).astype(dtype)
        out = tmp_path / np.dtype(dtype).name
        paths = tdw.write_dicom_series(
            tio.MedicalImage(array=arr, spacing=(0.5, 0.5, 4.0), direction=OBLIQUE), out,
            jpeg_lossless=True)
        assert tdcm.DicomFile(paths[0]).transfer_syntax == "1.2.840.10008.1.2.4.70"
        got = tio.read_medical_image(out)
        np.testing.assert_array_equal(got.array, arr)
        _assert_same_image(got, jio.read_medical_image(out))


def test_nifti_zero_slope_disables_scaling(tmp_path):
    volume = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    path = tmp_path / "vol.nii"
    tio.write_medical_image(tio.MedicalImage(array=volume, spacing=(1.0, 1.0, 1.0)), path)
    raw = bytearray(path.read_bytes())
    struct.pack_into("<f", raw, 112, 0.0)
    struct.pack_into("<f", raw, 116, 100.0)
    path.write_bytes(bytes(raw))
    back = tio.read_medical_image(path)
    np.testing.assert_array_equal(back.array, volume)
    assert back.array.dtype == np.int16
    _assert_same_image(back, jio.read_medical_image(path))


def _nifti_header_variant(path, **fields):
    raw = bytearray(path.read_bytes())
    for offset, (fmt, value) in fields.items():
        struct.pack_into(fmt, raw, int(offset), *value)
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("case", ["qform", "pixdim", "slope", "nan_slope", "big_endian", "4d"])
def test_nifti_header_paths_match_jax(tmp_path, case):
    """The qform quaternion (sform off), the pixdim fallback, a real
    slope/intercept, NaN scaling, a big-endian file and a 4-D header."""
    rng = np.random.default_rng(7)
    volume = rng.integers(-100, 100, (3, 5, 4)).astype(np.int16)
    path = tmp_path / "vol.nii"
    tio.write_nifti(tio.MedicalImage(array=volume, spacing=(0.8, 0.9, 2.0), origin=(4, 5, 6)),
                    path)
    if case == "qform":
        _nifti_header_variant(path, **{"254": ("<h", (0,)), "252": ("<h", (1,)),
                                        "256": ("<6f", (0.1, 0.2, 0.3, 1.0, 2.0, 3.0)),
                                        "76": ("<f", (-1.0,))})
    elif case == "pixdim":
        _nifti_header_variant(path, **{"254": ("<h", (0,))})
    elif case == "slope":
        _nifti_header_variant(path, **{"112": ("<f", (2.5,)), "116": ("<f", (-3.0,))})
    elif case == "nan_slope":
        _nifti_header_variant(path, **{"112": ("<f", (float("nan"),)),
                                        "116": ("<f", (float("nan"),))})
    elif case == "4d":
        _nifti_header_variant(path, **{"40": ("<8h", (4, 4, 5, 3, 2, 1, 1, 1))})
        path.write_bytes(path.read_bytes() + volume.tobytes())
    else:  # big-endian: every header field and the voxels byte-swapped
        data = path.read_bytes()
        hdr = bytearray(352)
        for off, fmt in ((0, "i"), (40, "8h"), (70, "h"), (72, "h"), (76, "8f"), (108, "f"),
                         (112, "f"), (116, "f"), (252, "h"), (254, "h"), (256, "6f"),
                         (280, "12f")):
            struct.pack_into(">" + fmt, hdr, off, *struct.unpack_from("<" + fmt, data, off))
        hdr[344:348] = data[344:348]
        path.write_bytes(bytes(hdr) + volume.astype(">i2").tobytes())
    _assert_same_image(tio.read_nifti(path), jio.read_nifti(path))


def test_dicom_series_write_read_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    volume = rng.integers(-500, 3000, (4, 16, 12)).astype(np.int16)
    image = tio.MedicalImage(array=volume, spacing=(0.6, 0.8, 3.0), origin=(5.0, -7.0, 2.0))
    out = tmp_path / "series"
    tio.write_medical_image(image, out)
    assert len(list(out.glob("*.dcm"))) == 4
    back = tio.read_medical_image(out)
    np.testing.assert_array_equal(back.array, volume)
    np.testing.assert_allclose(back.spacing, image.spacing, rtol=1e-5)
    np.testing.assert_allclose(back.origin, image.origin, atol=1e-5)


def test_dicom_single_file_write_read_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    plane = rng.integers(0, 4000, (1, 10, 14)).astype(np.uint16)
    path = tmp_path / "slice.dcm"
    tio.write_medical_image(tio.MedicalImage(array=plane, spacing=(0.5, 0.5, 1.0)), path)
    back = tio.read_medical_image(path)
    np.testing.assert_array_equal(np.squeeze(back.array), plane[0])
    with pytest.raises(ValueError, match="multi-slice"):
        tio.write_medical_image(tio.MedicalImage(array=np.zeros((2, 3, 3), np.int16)),
                                tmp_path / "two.dcm")


def test_dicom_write_rejects_float(tmp_path):
    image = tio.MedicalImage(array=np.zeros((2, 4, 4), dtype=np.float32))
    with pytest.raises(ValueError, match="integer"):
        tio.write_medical_image(image, tmp_path / "series")
    with pytest.raises(ValueError, match="Unsupported output format"):
        tio.write_medical_image(image, tmp_path / "vol.png")


def test_convert_format_and_detect(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 900, (3, 6, 5)).astype(np.int16)
    src = tmp_path / "a.nrrd"
    tio.write_medical_image(tio.MedicalImage(array=arr, spacing=(0.5, 0.6, 3.0)), src)
    tio.convert_format(src, tmp_path / "b.mha")
    np.testing.assert_array_equal(tio.read_medical_image(tmp_path / "b.mha").array, arr)
    for name in ("x.nii", "x.NII.GZ", "x.mha", "x.mhd", "x.nrrd", "x.dcm", "x.png"):
        assert tio.detect_format(tmp_path / name).name == jio.detect_format(tmp_path / name).name
    assert tio.detect_format(tmp_path).name == "DICOM"
    with pytest.raises(FileNotFoundError):
        tio.read_medical_image(tmp_path / "missing.mha")
    (tmp_path / "x.png").write_bytes(b"")
    with pytest.raises(ValueError, match="Unsupported format"):
        tio.read_medical_image(tmp_path / "x.png")


@pytest.mark.parametrize("case", ["none_first", "spacings", "ras", "zlib", "2d", "big_endian"])
def test_nrrd_headers_match_jax(tmp_path, case):
    """'none' before a vector (the regression of test_io.py), ``spacings``
    without directions, a RAS space, a zlib body, a 2-D file and big-endian
    data."""
    data = np.arange(2 * 4 * 5, dtype=np.float32).reshape(5, 4, 2)
    lines = ["NRRD0004", "dimension: 3", "sizes: 2 4 5", "type: float", "encoding: raw",
             "endian: little", "space: left-posterior-superior",
             "space directions: (1.5,0,0) (0,2.5,0) (0,0,3)"]
    payload = data.tobytes()
    if case == "none_first":
        lines[-1] = "space directions: none (1.5,0,0) (0,2.5,0)"
    elif case == "spacings":
        lines[-1] = "spacings: 1.5 2.5 nan"
    elif case == "ras":
        lines[6] = "space: right-anterior-superior"
        lines.append("space origin: (10,20,30)")
    elif case == "zlib":
        lines[4] = "encoding: zlib"
        payload = zlib.compress(payload)
    elif case == "2d":
        data = data[0]
        lines[1:3] = ["dimension: 2", "sizes: 2 4"]
        lines[-1] = "space directions: (1.5,0) (0,2.5)"
        payload = data.tobytes()
    else:
        lines[5] = "endian: big"
        payload = data.astype(">f4").tobytes()
    path = tmp_path / "seg.nrrd"
    path.write_bytes(("\n".join(lines) + "\n\n").encode() + payload)
    got = tio.read_nrrd(path)
    _assert_same_image(got, jio.read_nrrd(path))
    np.testing.assert_array_equal(np.squeeze(got.array), data)


@pytest.mark.parametrize("case", ["msb", "element_size", "2d", "no_matrix"])
def test_metaimage_headers_match_jax(tmp_path, case):
    data = np.arange(3 * 4 * 5, dtype=np.int16).reshape(3, 4, 5)
    lines = ["ObjectType = Image", "NDims = 3", "DimSize = 5 4 3", "ElementType = MET_SHORT",
             "ElementSpacing = 0.5 0.6 2", "TransformMatrix = 0 1 0 1 0 0 0 0 1",
             "ElementDataFile = LOCAL"]
    payload = data.tobytes()
    if case == "msb":
        lines.insert(1, "ElementByteOrderMSB = True")
        payload = data.astype(">i2").tobytes()
    elif case == "element_size":
        lines[4] = "ElementSize = 0.5 0.6 2"
    elif case == "2d":
        data = data[0]
        lines[1:3] = ["NDims = 2", "DimSize = 5 4"]
        lines[4:6] = ["ElementSpacing = 0.5 0.6", "TransformMatrix = 1 0 0 1"]
        payload = data.tobytes()
    else:
        del lines[5]
    path = tmp_path / "vol.mha"
    path.write_bytes(("\n".join(lines) + "\n").encode() + payload)
    got = tio.read_metaimage(path)
    _assert_same_image(got, jio.read_metaimage(path))
    np.testing.assert_array_equal(np.squeeze(got.array), data)


# ---------------------------------------------------------------------------
# DICOM datasets: transfer syntaxes, encapsulation, photometric and scaling
# ---------------------------------------------------------------------------


def _write_dicom_with(path, extra_body=b"", series_uid=b"1.2.3\x00", photometric=None,
                      instance=b"1 ", value=7, include_pixels=True, include_uid=True):
    rows, cols = 4, 6
    parts = [_element(0x0008, 0x0060, b"CS", b"MR")]
    if include_uid:
        parts.append(_element(0x0020, 0x000E, b"UI", series_uid))
    parts.append(_element(0x0020, 0x0013, b"IS", instance))
    parts += [
        _element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _element(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
    ]
    if photometric is not None:
        parts.append(_element(0x0028, 0x0004, b"CS", photometric))
    parts.append(extra_body)
    if include_pixels:
        pixels = np.full((rows, cols), value, dtype=np.uint16).tobytes()
        parts.append(_element(0x7FE0, 0x0010, b"OW", pixels))
    path.write_bytes(_part10("1.2.840.10008.1.2.1", b"".join(parts)))


def test_series_skips_empty_uid_group(tmp_path):
    _write_dicom_with(tmp_path / "DICOMDIR", include_uid=False, include_pixels=False)
    _write_dicom_with(tmp_path / "a.dcm", value=9)
    (tmp_path / "notes.txt").write_text("not a dicom file")
    volume = tdcm.read_dicom_series(tmp_path)
    assert volume.array.shape == (1, 4, 6) and int(volume.array[0, 0, 0]) == 9
    _assert_same_image(volume, jdcm.read_dicom_series(tmp_path))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No DICOM series"):
        tdcm.read_dicom_series(tmp_path / "empty")


def test_monochrome1_inversion_is_slice_consistent(tmp_path):
    bits_stored = _element(0x0028, 0x0101, b"US", struct.pack("<H", 12))
    _write_dicom_with(tmp_path / "a.dcm", extra_body=bits_stored, photometric=b"MONOCHROME1",
                      value=100)
    arr = tdcm.DicomFile(tmp_path / "a.dcm").pixel_array()
    assert int(arr[0, 0]) == (2**12 - 1) - 100
    np.testing.assert_array_equal(arr, jdcm.DicomFile(tmp_path / "a.dcm").pixel_array())


def test_undefined_length_un_sequence_parses(tmp_path):
    inner = struct.pack("<HHI", 0x0009, 0x0001, 4) + b"ABCD"
    item = struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF) + inner
    item += struct.pack("<HHI", 0xFFFE, 0xE00D, 0)
    seq = (struct.pack("<HH", 0x0009, 0x0010) + b"UN" + b"\x00\x00"
           + struct.pack("<I", 0xFFFFFFFF) + item + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    # An explicit SQ of undefined length with a defined-length item beside it.
    sq_item = _element(0x0008, 0x0100, b"SH", b"CODE")
    sq = (struct.pack("<HH", 0x0008, 0x1140) + b"SQ\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
          + struct.pack("<HHI", 0xFFFE, 0xE000, len(sq_item)) + sq_item
          + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    _write_dicom_with(tmp_path / "a.dcm", extra_body=seq + sq, value=5)
    arr = tdcm.DicomFile(tmp_path / "a.dcm").pixel_array()
    assert int(arr[0, 0]) == 5
    np.testing.assert_array_equal(arr, jdcm.DicomFile(tmp_path / "a.dcm").pixel_array())


def test_raw_explicit_vr_dataset_sniffed(tmp_path):
    rows, cols = 4, 6
    pixels = np.full((rows, cols), 3, dtype=np.uint16).tobytes()
    body = b"".join([
        _element(0x0008, 0x0060, b"CS", b"MR"),
        _element(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        _element(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        _element(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        _element(0x0028, 0x0103, b"US", struct.pack("<H", 0)),
        _element(0x7FE0, 0x0010, b"OW", pixels),
    ])
    (tmp_path / "raw.dcm").write_bytes(body)
    f = tdcm.DicomFile(tmp_path / "raw.dcm")
    assert f.pixel_array().shape == (4, 6) and int(f.pixel_array()[0, 0]) == 3
    # The same dataset in implicit VR, also without a preamble.
    implicit = b"".join([
        _implicit(0x0008, 0x0060, b"MR"),
        _implicit(0x0028, 0x0010, struct.pack("<H", rows)),
        _implicit(0x0028, 0x0011, struct.pack("<H", cols)),
        _implicit(0x0028, 0x0100, struct.pack("<H", 16)),
        _implicit(0x7FE0, 0x0010, pixels),
    ])
    (tmp_path / "raw_implicit.dcm").write_bytes(implicit)
    for name in ("raw.dcm", "raw_implicit.dcm"):
        np.testing.assert_array_equal(tdcm.DicomFile(tmp_path / name).pixel_array(),
                                      jdcm.DicomFile(tmp_path / name).pixel_array())


def test_truncated_pixeldata_is_dicom_error(tmp_path):
    short_pixels = np.full((4, 6), 7, dtype=np.uint16).tobytes()[:-8]
    _write_dicom_with(tmp_path / "a.dcm", include_pixels=False,
                      extra_body=_element(0x7FE0, 0x0010, b"OW", short_pixels))
    with pytest.raises(tdcm.DicomError, match="truncated"):
        tdcm.DicomFile(tmp_path / "a.dcm").pixel_array()
    _write_dicom_with(tmp_path / "b.dcm", include_pixels=False)
    with pytest.raises(tdcm.DicomError, match="No pixel data"):
        tdcm.DicomFile(tmp_path / "b.dcm").pixel_array()


def _packbits(data: bytes) -> bytes:
    """PackBits: a replicate run for 3+ equal bytes, literals otherwise."""
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _rle_frame(planes: list[np.ndarray]) -> bytes:
    """One RLE frame: byte segments (MSB first for 16 bits) after the
    64-byte header of offsets."""
    segments = []
    for plane in planes:
        if plane.dtype.itemsize == 2:
            u = plane.view(np.uint16)
            segments += [_packbits((u >> 8).astype(np.uint8).tobytes()),
                         _packbits((u & 0xFF).astype(np.uint8).tobytes())]
        else:
            segments.append(_packbits(plane.view(np.uint8).tobytes()))
    header = struct.pack("<I", len(segments))
    offsets, pos = [], 64
    for seg in segments:
        offsets.append(pos)
        pos += len(seg)
    header += struct.pack("<15I", *(offsets + [0] * (15 - len(offsets))))
    frame = header + b"".join(segments)
    return frame + (b"\x00" if len(frame) % 2 else b"")


def _encapsulated(fragments: list[bytes], bot: bytes = b"") -> bytes:
    items = struct.pack("<HHI", 0xFFFE, 0xE000, len(bot)) + bot
    for frag in fragments:
        items += struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag
    return (struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
            + items + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))


def _image_module(rows, cols, bits=16, signed=False, frames=1, spp=1, photometric=None,
                  rescale=None, little=True):
    us = lambda g, e, v: _element(g, e, b"US", struct.pack("<H" if little else ">H", v),  # noqa: E731
                                  little)
    parts = [
        _element(0x0008, 0x0060, b"CS", b"MR", little),
        _element(0x0020, 0x000E, b"UI", b"1.2.9\x00", little),
        _element(0x0020, 0x0032, b"DS", b"1\\2\\3 ", little),
        _element(0x0020, 0x0037, b"DS", b"0\\1\\0\\0\\0\\-1", little),
        us(0x0028, 0x0002, spp),
    ]
    if photometric:
        parts.append(_element(0x0028, 0x0004, b"CS", photometric, little))
    if frames > 1:
        parts.append(_element(0x0028, 0x0008, b"IS", f"{frames} ".encode()[:2], little))
    parts += [us(0x0028, 0x0010, rows), us(0x0028, 0x0011, cols),
              _element(0x0028, 0x0030, b"DS", b"0.7\\0.6 ", little),
              us(0x0028, 0x0100, bits), us(0x0028, 0x0101, bits),
              us(0x0028, 0x0103, int(signed))]
    if rescale:
        parts += [_element(0x0028, 0x1052, b"DS", rescale[1], little),
                  _element(0x0028, 0x1053, b"DS", rescale[0], little)]
    return b"".join(parts)


DICOM_CASES = ["implicit", "big_endian", "deflated", "rle8", "rle16_signed", "rle_rgb",
               "monochrome1_signed", "rescale", "signed16", "int32", "rgb_native",
               "multiframe_native", "jll_multiframe_bot", "jll_multiframe_no_bot",
               "jll_split_fragments_bot", "jll_8bit_signed", "jll_57"]


def _dicom_case(case: str, rng) -> tuple[bytes, np.ndarray | None]:
    """(file bytes, the stored pixels) of one DICOM case."""
    rows, cols = 6, 5
    u16 = rng.integers(0, 4000, (rows, cols)).astype(np.uint16)
    s16 = rng.integers(-2000, 2000, (rows, cols)).astype(np.int16)
    ex_le = "1.2.840.10008.1.2.1"
    if case == "implicit":
        body = b"".join(_implicit(g, e, v) for g, e, v in (
            (0x0008, 0x0060, b"MR"), (0x0028, 0x0010, struct.pack("<H", rows)),
            (0x0028, 0x0011, struct.pack("<H", cols)), (0x0028, 0x0100, struct.pack("<H", 16)),
            (0x7FE0, 0x0010, u16.tobytes())))
        return _part10("1.2.840.10008.1.2", body), u16
    if case == "big_endian":
        body = _image_module(rows, cols, little=False) + _element(
            0x7FE0, 0x0010, b"OW", u16.astype(">u2").tobytes(), little=False)
        return _part10("1.2.840.10008.1.2.2", body), u16
    if case == "deflated":
        body = _image_module(rows, cols) + _element(0x7FE0, 0x0010, b"OW", u16.tobytes())
        deflate = zlib.compressobj(9, zlib.DEFLATED, -15)
        return _part10("1.2.840.10008.1.2.1.99", deflate.compress(body) + deflate.flush()), u16
    if case.startswith("rle"):
        if case == "rle8":
            planes, mod = [u16.astype(np.uint8)], _image_module(rows, cols, bits=8)
        elif case == "rle16_signed":
            s16[0, :] = 5  # a replicate run
            planes, mod = [s16], _image_module(rows, cols, signed=True)
        else:
            planes = [rng.integers(0, 255, (rows, cols)).astype(np.uint8) for _ in range(3)]
            mod = _image_module(rows, cols, bits=8, spp=3)
        return _part10("1.2.840.10008.1.2.5", mod + _encapsulated([_rle_frame(planes)])), None
    if case == "monochrome1_signed":
        body = _image_module(rows, cols, signed=True, photometric=b"MONOCHROME1")
        return _part10(ex_le, body + _element(0x7FE0, 0x0010, b"OW", s16.tobytes())), None
    if case == "rescale":
        body = _image_module(rows, cols, rescale=(b"2.5 ", b"-100"))
        return _part10(ex_le, body + _element(0x7FE0, 0x0010, b"OW", u16.tobytes())), None
    if case == "signed16":
        body = _image_module(rows, cols, signed=True)
        return _part10(ex_le, body + _element(0x7FE0, 0x0010, b"OW", s16.tobytes())), s16
    if case == "int32":
        v = rng.integers(-70000, 70000, (rows, cols)).astype(np.int32)
        body = _image_module(rows, cols, bits=32, signed=True)
        return _part10(ex_le, body + _element(0x7FE0, 0x0010, b"OW", v.tobytes())), v
    if case == "rgb_native":
        v = rng.integers(0, 255, (rows, cols, 3)).astype(np.uint8)
        body = _image_module(rows, cols, bits=8, spp=3)
        return _part10(ex_le, body + _element(0x7FE0, 0x0010, b"OB", v.tobytes())), None
    if case == "multiframe_native":
        v = rng.integers(0, 4000, (3, rows, cols)).astype(np.uint16)
        body = _image_module(rows, cols, frames=3)
        return _part10(ex_le, body + _element(0x7FE0, 0x0010, b"OW", v.tobytes())), v
    # JPEG Lossless frames
    frames = 3 if "multiframe" in case or "split" in case else 1
    signed = "signed" in case
    bits = 8 if "8bit" in case else 16
    if bits == 8:
        v = rng.integers(-128, 128, (frames, rows, cols)).astype(np.int8)
        enc = [encode_jpeg_lossless(f.view(np.uint8).astype(np.uint16), precision=8)
               for f in v]
    else:
        v = rng.integers(0, 4000, (frames, rows, cols)).astype(np.uint16)
        enc = [encode_jpeg_lossless(f) for f in v]
    enc = [e + (b"\x00" if len(e) % 2 else b"") for e in enc]
    bot, frags = b"", enc
    if case == "jll_multiframe_bot" or case == "jll_split_fragments_bot":
        if case == "jll_split_fragments_bot":
            frags = [part for e in enc for part in (e[:10], e[10:])]
            sizes = [len(e) + 16 for e in enc]  # two item headers a frame
        else:
            sizes = [len(e) + 8 for e in enc]
        bot = struct.pack(f"<{frames}I", *np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    ts = "1.2.840.10008.1.2.4.57" if case == "jll_57" else "1.2.840.10008.1.2.4.70"
    mod = _image_module(rows, cols, bits=bits, signed=signed, frames=frames)
    return _part10(ts, mod + _encapsulated(frags, bot)), v[0] if frames == 1 else v


@pytest.mark.parametrize("case", DICOM_CASES)
def test_dicom_datasets_match_jax(tmp_path, case):
    data, stored = _dicom_case(case, np.random.default_rng(len(case)))
    path = tmp_path / f"{case}.dcm"
    path.write_bytes(data)
    got = tdcm.DicomFile(path).pixel_array()
    want = jdcm.DicomFile(path).pixel_array()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if stored is not None:
        np.testing.assert_array_equal(got, stored)
    _assert_same_image(tdcm.read_dicom_file(path), jdcm.read_dicom_file(path))


def _outcome(fn):
    """``fn()``'s value, or the type of what it raised."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the error is the outcome
        return type(exc)


def _j2k_frame(ts: str, shape: tuple, rng) -> bytes:
    """A JPEG 2000 frame as a .90 (5/3) or .91 (9/7) DICOM file carries it:
    a 12-bit gray frame (decoded by Pillow as ``x << 4``) or an RGB one."""
    import io as _io

    from fixtures.torch_jpeg2000.generate import encode_12_bit
    from PIL import Image

    lossy = ts.endswith(".91")
    kw = {"irreversible": True, "quality_layers": [20]} if lossy else {}
    if len(shape) == 2:
        return encode_12_bit(rng.integers(0, 4096, shape).astype(np.uint16), **kw)
    buf = _io.BytesIO()
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
        buf, "JPEG2000", no_jp2=True, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("ts", ["1.2.840.10008.1.2.4.50", "1.2.840.10008.1.2.4.51",
                                "1.2.840.10008.1.2.4.90", "1.2.840.10008.1.2.4.91"])
def test_pil_transfer_syntaxes_raise_before_decoding(tmp_path, ts):
    """Frames the JAX package hands to PIL decode to the JAX package's
    arrays (none raises any more; the name is kept so the test's history
    stays one), a gray frame and an RGB one, in a single file and in a series:
    baseline and extended JPEG (.50, .51) converted to L; JPEG 2000 (.90,
    .91) in Pillow's own mode (a 12-bit gray frame as ``x << 4`` uint16, an
    RGB frame as uint8 [1, rows, cols, 3]), with the same outcome for the series
    (the RGB series raises where the JAX package raises)."""
    import io as _io

    from PIL import Image

    j2k = ts.endswith((".90", ".91"))
    rng = np.random.default_rng(int(ts[-2:]))
    rows, cols = 21, 19
    for k, shape in enumerate(((rows, cols), (rows, cols, 3))):
        series = tmp_path / f"s{k}"
        series.mkdir()
        for i in range(3):
            if j2k:
                frame = _j2k_frame(ts, shape, rng)
                frame += b"\x00" * (len(frame) % 2)
            else:
                buf = _io.BytesIO()
                Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(
                    buf, "JPEG", quality=80)
                frame = buf.getvalue()
            module = _image_module(rows, cols, bits=16 if j2k else 8).replace(
                b"1\\2\\3 ", f"1\\2\\{i + 3} ".encode())
            path = series / f"{i}.dcm"
            path.write_bytes(_part10(ts, module + _encapsulated([frame])))
            got = tdcm.DicomFile(path).pixel_array()
            want = jdcm.DicomFile(path).pixel_array()
            assert got.dtype == want.dtype and got.shape == want.shape
            if j2k:
                # The JAX package squeezes a single frame of [1, rows, cols]
                # only: an RGB frame stays [1, rows, cols, 3].
                assert got.dtype == (np.uint16 if len(shape) == 2 else np.uint8)
                assert got.shape == (shape if len(shape) == 2 else (1, *shape))
            else:
                assert got.dtype == np.uint8 and got.shape == (rows, cols)
            np.testing.assert_array_equal(got, want)
        got = _outcome(lambda: tio.read_medical_image(series))
        want = _outcome(lambda: jio.read_medical_image(series))
        if isinstance(want, type):
            assert got is want or issubclass(got, want), (got, want)
        else:
            _assert_same_image(got, want)


def test_pdf_raises_the_reference_import_error(tmp_path):
    """Without PyMuPDF the JAX package raises ImportError at every PDF entry
    point; the port renders the same file without it (its own renderer,
    ``io/pdf_render.py``): RGB uint8 at the page box times dpi / 72."""
    from pathlib import Path

    pdf = Path(__file__).resolve().parent / "fixtures" / "torch_pdf" / "rotate90.pdf"
    for name in ("pdf_to_arrays", "pdf_first_page_to_array"):
        with pytest.raises(ImportError, match="PyMuPDF"):
            getattr(jpdf, name)(pdf)
    with pytest.raises(ImportError, match="PyMuPDF"):
        jpdf.pdf_to_images(pdf, tmp_path / "jax")
    pages = tpdf.pdf_to_arrays(pdf, dpi=144)
    first = tpdf.pdf_first_page_to_array(pdf, dpi=144)
    # CropBox 320 x 240 pt turned by /Rotate 90, at 2 pixels a point.
    assert [p.shape for p in pages] == [(640, 480, 3)] and pages[0].dtype == np.uint8
    np.testing.assert_array_equal(first, pages[0])
    assert [p.name for p in tpdf.pdf_to_images(pdf, tmp_path / "out", dpi=144)] == [
        "rotate90_page1.png"]


def test_io_exports_the_jax_names():
    assert sorted(tio.__all__) == sorted(jio.__all__)
