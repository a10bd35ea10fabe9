"""Write the JPEG 2000 and progressive JPEG fixtures and their record.

    python tests/fixtures/torch_jpeg2000/generate.py

Needs Pillow (the record names its version and OpenJPEG's; the files were
made with Pillow 12.1.0 on OpenJPEG 2.5.4). The files:

- ``series90/slice_00.j2k`` .. ``slice_16.j2k``: a seeded 17-slice 256x256
  12-bit series, lossless (5/3, the DICOM .90 case) raw codestreams.
  Pillow's encoder writes 8 or 16 bits only, so each slice is encoded as
  16-bit ``x + 30720`` and then edited to 12 bits (:func:`to_12_bit`);
  Pillow decodes it to ``x << 4``.
- ``series91/slice_00.j2k`` .. ``slice_16.j2k``: a seeded 17-slice 512x512
  16-bit series (values 0..4000), lossy (9/7, ``quality_layers=[20]``, the
  DICOM .91 case) raw codestreams.
- ``progressive/gray_512.jpg``: slice 0 of the .91 series scaled to 8 bits,
  a progressive JPEG at quality 75;
  ``progressive/color_420_rst.jpg``: a seeded 77x96 RGB image, progressive
  at 4:2:0, quality 85, a restart marker every 2 MCUs;
  ``progressive/report_clean.jpg``: ``tests/fixtures/torch_ocr/report_clean.png``
  (the OCR fixtures' first report page) as a progressive RGB JPEG, quality 90.

``record.json`` holds each file's shape, mode, dtype and the sha256 of
Pillow's decoded array (``np.asarray(Image.open(f))``), so a host without
Pillow can hold ``spine_vision_torch/io/jpeg2000.py`` and ``io/jpeg.py`` to
it (``tests/test_torch_jpeg2000.py`` and ``chip_smoke.py``'s ``codecs``
phase).
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SLICES = 17
SIDE_90, SIDE_91 = 256, 512


def mr_series(side: int, seed: int, top: float = 4000.0, noise: float = 12.0) -> np.ndarray:
    """uint16 [17, side, side]: a few soft ellipses a slice over a smooth
    background, with Gaussian noise, drifting from slice to slice (an MR
    series at 12 bits)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side] / side
    centres = rng.uniform(0.2, 0.8, (6, 2))
    radii = rng.uniform(0.05, 0.2, (6, 2))
    levels = rng.uniform(0.25, 0.6, 6) * top
    out = []
    for k in range(SLICES):
        img = 0.1 * top + 0.08 * top * np.sin(3 * x + 2 * y + k / 5)
        for (cy, cx), (ry, rx), level in zip(centres, radii, levels):
            d = ((y - cy - 0.01 * k) / ry) ** 2 + ((x - cx) / rx) ** 2
            img = img + level * np.exp(-d * 2)
        img = img + rng.normal(0, noise, img.shape)
        out.append(np.clip(img, 0, top).astype(np.uint16))
    return np.stack(out)


def to_12_bit(codestream: bytes) -> bytes:
    """Edit a 16-bit one-component codestream of ``x + 30720`` into a 12-bit
    one of ``x``: the first component's Ssiz 15 -> 11, and in QCD 4 more
    guard bits and each exponent 4 less, so Mb and the step sizes stay and
    the packet headers stay valid."""
    d = bytearray(codestream)
    siz = d.index(b"\xff\x51")
    if d[siz + 40] != 15:
        raise ValueError(f"Ssiz {d[siz + 40]}: not a 16-bit unsigned first component")
    d[siz + 40] = 11
    q = d.index(b"\xff\x5c")
    length = struct.unpack_from(">H", d, q + 2)[0]
    style = d[q + 4] & 0x1F
    d[q + 4] += 4 << 5
    if style == 0:
        for i in range(q + 5, q + 2 + length):
            d[i] -= 4 << 3
    else:
        for i in range(q + 5, q + 2 + length, 2):
            struct.pack_into(">H", d, i, struct.unpack_from(">H", d, i)[0] - (4 << 11))
    return bytes(d)


def encode_12_bit(x: np.ndarray, **kw) -> bytes:
    """A 12-bit raw codestream of ``x`` (uint16, values below 4096), made
    with Pillow's 16-bit encoder and :func:`to_12_bit`."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((x.astype(np.uint32) + 30720).astype(np.uint16)).save(
        buf, "JPEG2000", no_jp2=True, **kw)
    return to_12_bit(buf.getvalue())


def color_image(seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:77, 0:96]
    planes = [127 + 90 * np.sin(x / (4 + 3 * c) + y / (6 + c)) + rng.normal(0, 12, x.shape)
              for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def record_entry(path: Path) -> dict:
    """Pillow's decode of ``path``: shape, mode, dtype and sha256."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
        return {"shape": list(arr.shape), "mode": im.mode, "dtype": str(arr.dtype),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def main() -> None:
    import PIL
    from PIL import Image, features

    files = []
    for name in ("series90", "series91", "progressive"):
        (HERE / name).mkdir(exist_ok=True)
    for k, img in enumerate(mr_series(SIDE_90, 0)):
        name = f"series90/slice_{k:02d}.j2k"
        (HERE / name).write_bytes(encode_12_bit(img))
        files.append(name)
    lossy = mr_series(SIDE_91, 1)
    for k, img in enumerate(lossy):
        name = f"series91/slice_{k:02d}.j2k"
        Image.fromarray(img).save(HERE / name, "JPEG2000", no_jp2=True, irreversible=True,
                                  quality_layers=[20])
        files.append(name)
    gray = (lossy[0].astype(np.float64) * 255 / 4000).astype(np.uint8)
    Image.fromarray(gray).save(HERE / "progressive/gray_512.jpg", "JPEG", quality=75,
                               progressive=True)
    Image.fromarray(color_image()).save(HERE / "progressive/color_420_rst.jpg", "JPEG",
                                        quality=85, subsampling=2, progressive=True,
                                        restart_marker_blocks=2)
    page = Image.open(HERE.parent / "torch_ocr" / "report_clean.png").convert("RGB")
    page.save(HERE / "progressive/report_clean.jpg", "JPEG", quality=90, progressive=True)
    files += ["progressive/gray_512.jpg", "progressive/color_420_rst.jpg",
              "progressive/report_clean.jpg"]
    record = {"pillow": PIL.__version__, "openjpeg": features.version("jpg_2000"),
              "files": {name: record_entry(HERE / name) for name in files}}
    (HERE / "record.json").write_text(json.dumps(record, indent=1) + "\n")
    total = sum((HERE / n).stat().st_size for n in files)
    print(f"{len(files)} files, {total} bytes")


if __name__ == "__main__":
    main()
