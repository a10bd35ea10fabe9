"""Write the baseline JPEG fixtures and their record.

    python tests/fixtures/torch_jpeg/generate.py

Needs Pillow (the record names its version; the files were made with
12.1.0). The files, all written by Pillow's JPEG encoder:

- ``series/slice_00.jpg`` .. ``slice_16.jpg``: a seeded 17-slice 512x512
  gray series at quality 75 (smooth anatomy-like blobs and noise, as an MRI
  series exported to JPEG);
- ``color_444.jpg``, ``color_422.jpg``, ``color_420.jpg``: a seeded 77x96
  RGB image at each chroma subsampling, quality 85;
- ``restart.jpg``: the same image at 4:2:0 with a restart marker every 2
  MCUs (``restart_marker_blocks``);
- ``report_clean.jpg``: ``tests/fixtures/torch_ocr/report_clean.png`` (the
  OCR fixtures' first report page) as an RGB JPEG at quality 90.

``record.json`` holds each file's shape, mode and the sha256 of Pillow's
decoded array (``np.asarray(Image.open(f))``), so a host without Pillow can
hold ``spine_vision_torch/io/jpeg.py`` to it (``tests/test_torch_jpeg.py``
and ``chip_smoke.py``'s ``cli`` phase).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SLICES, SIDE = 17, 512


def series_slices(seed: int = 0) -> np.ndarray:
    """uint8 [17, 512, 512]: a few soft ellipses per slice over a smooth
    background, with Gaussian noise, drifting from slice to slice."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:SIDE, 0:SIDE] / SIDE
    centres = rng.uniform(0.2, 0.8, (6, 2))
    radii = rng.uniform(0.05, 0.2, (6, 2))
    levels = rng.uniform(60, 200, 6)
    out = []
    for k in range(SLICES):
        img = 40 + 30 * np.sin(3 * x + 2 * y + k / 5)
        for (cy, cx), (ry, rx), level in zip(centres, radii, levels):
            d = ((y - cy - 0.01 * k) / ry) ** 2 + ((x - cx) / rx) ** 2
            img = img + level * np.exp(-d * 2)
        img = img + rng.normal(0, 6, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def color_image(seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:77, 0:96]
    planes = [127 + 90 * np.sin(x / (4 + 3 * c) + y / (6 + c)) + rng.normal(0, 12, x.shape)
              for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def main() -> None:
    import PIL
    from PIL import Image

    files = {}
    (HERE / "series").mkdir(exist_ok=True)
    for k, img in enumerate(series_slices()):
        name = f"series/slice_{k:02d}.jpg"
        Image.fromarray(img).save(HERE / name, "JPEG", quality=75)
        files[name] = {}
    color = Image.fromarray(color_image())
    for name, sub in (("color_444.jpg", 0), ("color_422.jpg", 1), ("color_420.jpg", 2)):
        color.save(HERE / name, "JPEG", quality=85, subsampling=sub)
        files[name] = {}
    color.save(HERE / "restart.jpg", "JPEG", quality=85, subsampling=2, restart_marker_blocks=2)
    files["restart.jpg"] = {}
    page = Image.open(HERE.parent / "torch_ocr" / "report_clean.png").convert("RGB")
    page.save(HERE / "report_clean.jpg", "JPEG", quality=90)
    files["report_clean.jpg"] = {}
    for name in files:
        with Image.open(HERE / name) as im:
            arr = np.asarray(im)
            files[name] = {"shape": list(arr.shape), "mode": im.mode,
                           "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    record = {"pillow": PIL.__version__, "files": files}
    (HERE / "record.json").write_text(json.dumps(record, indent=1) + "\n")
    total = sum((HERE / n).stat().st_size for n in files)
    print(f"{len(files)} files, {total} bytes")


if __name__ == "__main__":
    main()
