"""Synthetic Vietnamese report text for OCR training and evaluation.

Counterpart of ``spine_vision_tpu/data/phenikaa/synth.py``: text lines for
the CTC recognizer, composite pages for the detector, fake report pages for
the end-to-end extraction checks, and the scan degradation of both. The JAX
package draws with Pillow and the system's DejaVu fonts; the port draws the
same text from the committed glyph atlas (``data/phenikaa/text.py``) and
applies Pillow's raster operations in numpy (``data/phenikaa/raster.py``).

Every draw from the numpy Generator is made in the JAX package's order, with
the same arguments and shapes: a line, a batch of lines and a degraded image
leave the Generator in the state the JAX function leaves it in, so the texts,
targets, fonts, sizes, slants and degradation parameters are the JAX
package's. A page draws its x position and truncation from rendered widths,
which the atlas reproduces to the pixel in all but a few strings.

Faces are named by their file stems (:data:`FONT_PATHS` for training,
:data:`HOLDOUT_FONT_PATHS` for the unseen-font evaluation, in the JAX
package's order, so that a draw picks the same face); the ``fonts=``
arguments take those names.
"""

from __future__ import annotations

import math

import numpy as np

from spine_vision_torch.data.phenikaa import raster
from spine_vision_torch.data.phenikaa.text import truetype
from spine_vision_torch.models.textrec import VIETNAMESE_CHARSET

FONT_PATHS = (
    "DejaVuSans-Bold", "DejaVuSans", "DejaVuSansMono-Bold", "DejaVuSansMono",
    "DejaVuSerif-Bold", "DejaVuSerif",
)
HOLDOUT_FONT_PATHS = (
    "DejaVuSans-BoldOblique", "DejaVuSans-Oblique", "DejaVuSansMono-BoldOblique",
    "DejaVuSansMono-Oblique", "DejaVuSerif-BoldItalic", "DejaVuSerif-Italic",
)

SURNAMES = (
    "Nguyễn", "Trần", "Lê", "Phạm", "Hoàng", "Huỳnh", "Phan", "Vũ", "Võ",
    "Đặng", "Bùi", "Đỗ", "Hồ", "Ngô", "Dương", "Lý", "Đào", "Trịnh",
)
MIDDLE_NAMES = ("Văn", "Thị", "Hữu", "Đức", "Công", "Quang", "Minh", "Ngọc", "Thu", "Xuân")
GIVEN_NAMES = (
    "An", "Bình", "Châu", "Dũng", "Giang", "Hà", "Hải", "Hạnh", "Hiếu",
    "Hương", "Khánh", "Lan", "Linh", "Long", "Mai", "Nam", "Nga", "Phúc",
    "Phương", "Quân", "Sơn", "Thảo", "Thắng", "Trang", "Tuấn", "Tùng",
    "Uyên", "Việt", "Yến", "Đạt",
)
FIELD_LABELS = (
    "Họ tên người bệnh",
    "Ngày sinh",
    "Số phiếu",
    "Giới tính",
    "Địa chỉ",
    "Chẩn đoán",
    "Bác sĩ chỉ định",
)

_CHARS = np.array(list(VIETNAMESE_CHARSET))


def sample_name(rng: np.random.Generator) -> str:
    parts = [
        SURNAMES[rng.integers(len(SURNAMES))],
        MIDDLE_NAMES[rng.integers(len(MIDDLE_NAMES))],
        GIVEN_NAMES[rng.integers(len(GIVEN_NAMES))],
    ]
    if rng.random() < 0.3:
        parts.insert(2, GIVEN_NAMES[rng.integers(len(GIVEN_NAMES))])
    return " ".join(parts)


def sample_date(rng: np.random.Generator) -> str:
    return (
        f"{rng.integers(1, 29):02d}/{rng.integers(1, 13):02d}/"
        f"{rng.integers(1940, 2015)}"
    )


def sample_line_text(rng: np.random.Generator, max_chars: int = 36) -> str:
    """Field-distribution text mixture for recognizer training."""
    kind = rng.random()
    if kind < 0.25:
        text = sample_name(rng)
    elif kind < 0.40:
        text = sample_date(rng)
    elif kind < 0.52:
        text = str(rng.integers(10000, 10**9))  # report / patient IDs
    elif kind < 0.72:
        label = FIELD_LABELS[rng.integers(len(FIELD_LABELS))]
        value = (
            sample_name(rng)
            if "tên" in label
            else sample_date(rng)
            if "sinh" in label
            else str(rng.integers(1000, 10**7))
        )
        text = f"{label}: {value}"
    else:
        n = int(rng.integers(3, max_chars))
        text = "".join(_CHARS[rng.integers(0, len(_CHARS), size=n)])
    text = text.strip()[:max_chars].strip()
    return text or "0"


def render_line(
    text: str,
    rng: np.random.Generator,
    height: int = 32,
    width: int = 256,
    augment: bool = True,
    fonts: tuple[str, ...] | None = None,
) -> np.ndarray:
    """One text line, dark glyphs on a light background: float32
    ``[height, width]`` in [0, 255].

    Drawn on a canvas twice the width, with the stroke-weight (3x3 min/max)
    and glyph-slant augmentations when ``augment``, cropped to the text and
    squeezed or stretched to ``width`` as ``rectify_polygons`` stretches a
    page's patches, then blurred, contrast-jittered and noised."""
    fonts = fonts or FONT_PATHS
    face = fonts[int(rng.integers(len(fonts)))]
    size = int(rng.integers(18, 27)) if augment else 22
    font = truetype(face, size)

    canvas_w = width * 2
    img = np.full((height, canvas_w), 255, np.uint8)
    x0 = int(rng.integers(1, 8)) if augment else 3
    bbox = font.getbbox(text)
    y0 = max(0, (height - (bbox[3] - bbox[1])) // 2 - bbox[1])
    font.draw(img, (x0, y0), text, 0)

    if augment:
        weight_draw = rng.random()
        if weight_draw < 0.2:
            img = raster.min_filter3(img)  # bolder
        elif weight_draw < 0.35:
            # Thinner: blend toward the 3x3 maximum (a full maximum erases
            # the 2 px stems of these sizes).
            alpha = rng.uniform(0.35, 0.65)
            thin = raster.max_filter3(img).astype(np.float32)
            base = img.astype(np.float32)
            img = np.clip(base + alpha * (thin - base), 0, 255).astype(np.uint8)

    slant = 0.0
    if augment and rng.random() < 0.5:
        slant = float(rng.uniform(-0.25, 0.25))
        img = raster.transform(
            img, (canvas_w, height), (1.0, slant, -slant * height / 2.0, 0.0, 1.0, 0.0), 255
        )

    used_w = min(canvas_w, bbox[2] - bbox[0] + x0 + 6 + int(abs(slant) * height / 2.0))
    img = raster.resize_bilinear(img[:, : max(used_w, 8)], (width, height))
    if augment and rng.random() < 0.3:
        img = raster.gaussian_blur(img, 0.6)
    arr = np.asarray(img, dtype=np.float32)

    if augment:
        contrast = 0.7 + 0.5 * rng.random()
        brightness = rng.uniform(-20.0, 20.0)
        arr = np.clip((arr - 128.0) * contrast + 128.0 + brightness, 0, 255)
        arr = np.clip(arr + rng.normal(0.0, 6.0, arr.shape), 0, 255)
    return arr.astype(np.float32)


def render_line_mpl(
    text: str,
    height: int = 32,
    width: int = 256,
    fontsize_px: float = 22.0,
    style: str = "normal",
    family: str = "DejaVu Sans",
) -> np.ndarray:
    """One text line through matplotlib's Agg text stack: the
    unseen-renderer evaluation surface (its own layout, hinting and
    antialiasing for the same text). Needs matplotlib, imported here, and
    raises ``ImportError`` without it. Returns float32 ``[height, width]``
    in [0, 255], dark glyphs on light."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    dpi = 72.0  # 1 pt == 1 px so fontsize_px maps directly
    canvas_w = width * 2
    fig = Figure(figsize=(canvas_w / dpi, height / dpi), dpi=dpi)
    fig.patch.set_facecolor("white")
    canvas = FigureCanvasAgg(fig)
    fig.text(3.0 / canvas_w, 0.5, text, fontsize=fontsize_px, family=family, style=style,
             va="center", ha="left", color="black")
    canvas.draw()
    rgba = np.asarray(canvas.buffer_rgba())
    gray = rgba[..., :3].astype(np.float32).mean(axis=-1)

    cols = np.where(gray.min(axis=0) < 160)[0]
    used_w = int(cols.max()) + 6 if cols.size else 8
    img = np.clip(gray, 0, 255).astype(np.uint8)[:, : max(used_w, 8)]
    return np.asarray(raster.resize_bilinear(img, (width, height)), dtype=np.float32)


def recognition_eval_batch_mpl(
    rng: np.random.Generator,
    n: int,
    width: int = 256,
    style: str = "normal",
) -> tuple[np.ndarray, list[str]]:
    """Evaluation-only batch rendered by matplotlib (:func:`render_line_mpl`),
    font sizes over the training range, no degradation."""
    texts = [sample_line_text(rng) for _ in range(n)]
    images = np.stack(
        [
            render_line_mpl(t, width=width, fontsize_px=float(rng.integers(18, 27)), style=style)
            for t in texts
        ]
    )
    return images.astype(np.float32), texts


def encode_text(text: str, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Text -> (padded CTC target ids [max_len], padding mask [max_len]).

    Character i of the charset maps to logit id i + 1 (0 = blank).
    """
    ids = [VIETNAMESE_CHARSET.index(c) + 1 for c in text if c in VIETNAMESE_CHARSET]
    ids = ids[:max_len]
    out = np.zeros(max_len, dtype=np.int32)
    out[: len(ids)] = ids
    pad = np.ones(max_len, dtype=np.float32)
    pad[: len(ids)] = 0.0
    return out, pad


def recognition_batch(
    rng: np.random.Generator,
    n: int,
    height: int = 32,
    width: int = 256,
    max_len: int = 40,
    augment: bool = True,
    degrade: str | None = None,
    degrade_p: float = 1.0,
    fonts: tuple[str, ...] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[str]]:
    """Rendered lines + CTC targets: (images [n,h,w], ids, pad, texts);
    each line degraded with ``degrade``'s profile with probability
    ``degrade_p``."""
    texts = [sample_line_text(rng) for _ in range(n)]

    def render(t: str) -> np.ndarray:
        arr = render_line(t, rng, height, width, augment=augment, fonts=fonts)
        if degrade is not None and rng.random() < degrade_p:
            arr = degrade_image(arr, rng, profile=degrade)
        return arr

    images = np.stack([render(t) for t in texts])
    encoded = [encode_text(t, max_len) for t in texts]
    ids = np.stack([e[0] for e in encoded])
    pad = np.stack([e[1] for e in encoded])
    return images, ids, pad, texts


def _crop(img: np.ndarray, x: int, y: int, w: int, h: int, fill: int = 0) -> np.ndarray:
    """``Image.crop((x, y, x + w, y + h))``: outside the image reads ``fill``."""
    out = np.full((h, w), fill, np.uint8)
    ya, yb = max(y, 0), min(y + h, img.shape[0])
    xa, xb = max(x, 0), min(x + w, img.shape[1])
    if ya < yb and xa < xb:
        out[ya - y : yb - y, xa - x : xb - x] = img[ya:yb, xa:xb]
    return out


def _paste(img: np.ndarray, patch: np.ndarray, x: int, y: int) -> None:
    """``Image.paste(patch, (x, y))``, clipped to the image."""
    ya, yb = max(y, 0), min(y + patch.shape[0], img.shape[0])
    xa, xb = max(x, 0), min(x + patch.shape[1], img.shape[1])
    if ya < yb and xa < xb:
        img[ya:yb, xa:xb] = patch[ya - y : yb - y, xa - x : xb - x]


def detection_page(
    rng: np.random.Generator,
    page_hw: tuple[int, int] = (320, 448),
    max_lines: int = 8,
    augment: bool = True,
    degrade: str | None = None,
    degrade_p: float = 1.0,
    fonts: tuple[str, ...] | None = None,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Composite page of text lines: (page [H,W], boxes [N,4] xyxy, texts).

    Lines sit on a jittered row grid, so boxes never overlap; a degraded
    page's boxes go through the same geometric transform."""
    fonts = fonts or FONT_PATHS
    h, w = page_hw
    img = np.full((h, w), int(rng.integers(235, 256)), np.uint8)
    boxes: list[tuple[float, float, float, float]] = []
    texts: list[str] = []
    n_lines = int(rng.integers(3, max_lines + 1))
    row_height = h // max_lines
    rows = rng.permutation(max_lines)[:n_lines]
    for row in sorted(rows):
        text = sample_line_text(rng, max_chars=28)
        face = fonts[int(rng.integers(len(fonts)))]
        size = int(rng.integers(14, 22)) if augment else 18
        font = truetype(face, size)
        bbox = font.getbbox(text)
        tw = bbox[2] - bbox[0]
        th = bbox[3] - bbox[1]
        if tw >= w - 16:
            text = text[: max(4, len(text) // 2)]
            bbox = font.getbbox(text)
            tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        slant = (
            float(rng.uniform(-0.25, 0.25))
            if augment and rng.random() < 0.5
            else 0.0
        )
        spread = int(abs(slant) * th) + (2 if slant else 0)
        line_w = tw + spread
        if line_w >= w - 16:
            slant, spread, line_w = 0.0, 0, tw
        x = int(rng.integers(8, max(9, w - line_w - 8)))
        y = int(row * row_height + rng.integers(2, max(3, row_height - th - 2)))
        fill = int(rng.integers(0, 40))
        if slant:
            tmp = np.full((th, line_w), 255, np.uint8)
            font.draw(tmp, (spread // 2 - bbox[0], -bbox[1]), text, fill)
            tmp = raster.transform(
                tmp, (line_w, th), (1.0, slant, -slant * th / 2.0, 0.0, 1.0, 0.0), 255
            )
            region = _crop(img, x, y, line_w, th)
            _paste(img, np.minimum(region, tmp), x, y)
        else:
            font.draw(img, (x - bbox[0], y - bbox[1]), text, fill)
        boxes.append((x - 2, y - 2, x + line_w + 2, y + th + 2))
        texts.append(text)
    arr = np.asarray(img, dtype=np.float32)
    if augment:
        arr = np.clip(arr + rng.normal(0.0, 5.0, arr.shape), 0, 255)
    boxes_arr = np.asarray(boxes, dtype=np.float32)
    if degrade is not None and rng.random() < degrade_p:
        arr, boxes_arr = degrade_image(arr, rng, profile=degrade, boxes=boxes_arr)
    return arr.astype(np.float32), boxes_arr, texts


def detection_target(
    boxes: np.ndarray, page_hw: tuple[int, int], scale: int = 2, shrink: float = 0.3
) -> np.ndarray:
    """Shrunk-box probability target at 1/scale resolution (DB formulation:
    the model learns text kernels; ``extract_boxes_from_probmap`` dilates by
    the matching unclip ratio)."""
    h, w = page_hw[0] // scale, page_hw[1] // scale
    target = np.zeros((h, w), dtype=np.float32)
    for x1, y1, x2, y2 in np.asarray(boxes, dtype=np.float32) / scale:
        bw, bh = x2 - x1, y2 - y1
        sx, sy = bw * shrink / 2.0, bh * shrink / 2.0
        xa, xb = int(round(x1 + sx)), int(round(x2 - sx))
        ya, yb = int(round(y1 + sy)), int(round(y2 - sy))
        target[max(ya, 0) : max(yb, 0), max(xa, 0) : max(xb, 0)] = 1.0
    return target


def render_report_page(
    patient_name: str,
    birthday: str,
    report_id: str,
    rng: np.random.Generator,
    page_hw: tuple[int, int] = (448, 640),
) -> np.ndarray:
    """A minimal fake Phenikaa report page with the three extraction
    fields, for the end-to-end extraction checks."""
    h, w = page_hw
    img = np.full((h, w), 250, np.uint8)
    font = truetype(FONT_PATHS[0], 20)
    lines = [
        "BỆNH VIỆN ĐẠI HỌC PHENIKAA",
        "PHIẾU CHỈ ĐỊNH CHỤP MRI",
        f"Số phiếu: {report_id}",
        f"Họ tên người bệnh: {patient_name}",
        f"Ngày sinh: {birthday}",
        "Chẩn đoán: Thoát vị đĩa đệm",
    ]
    y = 24
    for line in lines:
        font.draw(img, (24, y), line, 10)
        y += 42
    return np.asarray(img, dtype=np.float32)


def render_report_page_variant(
    patient_name: str,
    birthday: str,
    report_id: str,
    rng: np.random.Generator,
    page_hw: tuple[int, int] = (448, 640),
    font_path: str | None = None,
) -> np.ndarray:
    """An unseen-layout fake report page (evaluation only): a letterhead
    with clutter, a boxed report number top right, shuffled label/value
    pairs at mixed indentation and separators, a rule and per-line sizes,
    in the first holdout face unless ``font_path`` names another."""
    h, w = page_hw
    face = font_path or HOLDOUT_FONT_PATHS[0]
    img = np.full((h, w), 252, np.uint8)

    def text(x: int, y: int, s: str, size: int) -> None:
        truetype(face, size).draw(img, (x, y), s, 12)

    text(20, 14, "SỞ Y TẾ HÀ NỘI", 15)
    text(20, 36, "BỆNH VIỆN ĐẠI HỌC PHENIKAA", 19)
    text(20, 62, "Đường Nguyễn Trác, Hà Đông", 13)
    # ImageDraw.rectangle((w - 220, 16, w - 24, 78), outline=60, width=2):
    # a frame two pixels thick inside the inclusive box.
    x0, y0, x1, y1 = w - 220, 16, w - 24, 78
    img[y0 : y0 + 2, x0 : x1 + 1] = 60
    img[y1 - 1 : y1 + 1, x0 : x1 + 1] = 60
    img[y0 : y1 + 1, x0 : x0 + 2] = 60
    img[y0 : y1 + 1, x1 - 1 : x1 + 1] = 60
    text(w - 208, 24, "Số phiếu:", 14)
    text(w - 208, 46, report_id, 20)
    # ImageDraw.line((20, 92, w - 20, 92), fill=80, width=2): rows 92-93.
    img[92:94, 20 : w - 20 + 1] = 80
    text(170, 104, "PHIẾU CHỈ ĐỊNH CHỤP MRI", 18)

    fields = [
        ("Họ tên người bệnh", patient_name),
        ("Ngày sinh", birthday),
        ("Giới tính", "Nữ" if rng.random() < 0.5 else "Nam"),
        ("Địa chỉ", "Số 12 Tô Hiệu, Hà Đông, Hà Nội"),
        ("Chẩn đoán", "Thoát vị đĩa đệm L4/L5"),
    ]
    order = rng.permutation(len(fields))
    y = 148
    for idx in order:
        label, value = fields[idx]
        indent = 24 if idx % 2 == 0 else 48
        sep = ":" if rng.random() < 0.5 else " :"
        size = int(rng.integers(16, 21))
        text(indent, y, f"{label}{sep} {value}", size)
        y += int(rng.integers(38, 50))
    text(24, y + 10, f"Ngày chỉ định: {sample_date(rng)}", 14)
    return np.asarray(img, dtype=np.float32)


# ---------------------------------------------------------------------------
# Scan-style degradation: "mild" mirrors what training adds on top of the
# clean renderer; "hard" is the held-out evaluation profile, shifted harsher
# (the ranges overlap).
# ---------------------------------------------------------------------------

DEGRADE_PROFILES = {
    "mild": {
        "rotate_deg": 2.2,
        "shear": 0.06,
        "perspective": 0.012,
        "jpeg_q": (40, 90),
        "salt_pepper": 0.004,
        "vignette": 0.2,
        "lines": 2,
        "p_geom": 0.7,
        "p_jpeg": 0.6,
        "p_lines": 0.4,
    },
    "hard": {
        "rotate_deg": 3.0,
        "shear": 0.08,
        "perspective": 0.015,
        "jpeg_q": (30, 60),
        "salt_pepper": 0.006,
        "vignette": 0.3,
        "lines": 3,
        "p_geom": 1.0,
        "p_jpeg": 1.0,
        "p_lines": 0.7,
    },
}


def _affine_coeffs(width, height, rot_rad, shear_x, persp):
    """Output -> input coefficients of a PERSPECTIVE transform: rotation
    about the image centre, an x-shear and a small projective term."""
    cx, cy = width / 2.0, height / 2.0
    cos, sin = math.cos(rot_rad), math.sin(rot_rad)
    a, b = cos, sin + shear_x
    d, e = -sin, cos
    c = cx - a * cx - b * cy
    f = cy - d * cx - e * cy
    return (a, b, c, d, e, f, persp / max(width, 1), persp / max(height, 1))


def degrade_image(
    arr: np.ndarray,
    rng: np.random.Generator,
    profile: str = "mild",
    boxes: np.ndarray | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Scan-style degradation of a rendered line or page (float32 ``[H, W]``
    in [0, 255], light background): a rotation, shear and perspective, ruled
    lines, vignetting, salt and pepper, a JPEG round trip. Given ``boxes``
    (``[N, 4]`` xyxy), returns ``(image, boxes)`` with the boxes mapped
    through the same transform (the axis-aligned hull of the corners)."""
    p = DEGRADE_PROFILES[profile]
    h, w = arr.shape
    out_boxes = None if boxes is None else np.asarray(boxes, np.float64).copy()

    if rng.random() < p["p_geom"]:
        rot = np.deg2rad(rng.uniform(-p["rotate_deg"], p["rotate_deg"]))
        shear = rng.uniform(-p["shear"], p["shear"])
        persp = rng.uniform(-p["perspective"], p["perspective"])
        coeffs = _affine_coeffs(w, h, rot, shear, persp)
        img = np.clip(arr, 0, 255).astype(np.uint8)
        arr = raster.transform(img, (w, h), coeffs, 245, perspective=True).astype(np.float32)
        if out_boxes is not None and len(out_boxes):
            a, b, c, d, e, f, g, hh = coeffs
            # The coefficients map output to source: push the corners
            # forward through the homography's exact inverse.
            m = np.array([[a, b, c], [d, e, f], [g, hh, 1.0]])
            minv = np.linalg.inv(m)
            corners = np.stack(
                [
                    out_boxes[:, [0, 1]],
                    out_boxes[:, [2, 1]],
                    out_boxes[:, [0, 3]],
                    out_boxes[:, [2, 3]],
                ],
                axis=1,
            )  # [N, 4, 2]
            ones = np.ones((*corners.shape[:2], 1))
            hom = np.concatenate([corners, ones], axis=-1) @ minv.T
            xs = hom[..., 0] / hom[..., 2]
            ys = hom[..., 1] / hom[..., 2]
            out_boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)

    if rng.random() < p["p_lines"]:
        for _ in range(int(rng.integers(1, p["lines"] + 1))):
            shade = float(rng.uniform(120, 200))
            if rng.random() < 0.5:
                y = int(rng.integers(0, h))
                arr[y : y + 1, :] = np.minimum(arr[y : y + 1, :], shade)
            else:
                x = int(rng.integers(0, w))
                arr[:, x : x + 1] = np.minimum(arr[:, x : x + 1], shade)

    if p["vignette"] > 0:
        strength = rng.uniform(0.0, p["vignette"])
        yy, xx = np.mgrid[0:h, 0:w]
        r2 = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
        arr = arr * (1.0 - strength * r2 / 2.0)

    if p["salt_pepper"] > 0:
        mask = rng.random(arr.shape)
        arr = np.where(mask < p["salt_pepper"] / 2, 0.0, arr)
        arr = np.where(mask > 1.0 - p["salt_pepper"] / 2, 255.0, arr)

    if rng.random() < p["p_jpeg"]:
        q = int(rng.integers(p["jpeg_q"][0], p["jpeg_q"][1] + 1))
        arr = raster.jpeg_roundtrip(np.clip(arr, 0, 255).astype(np.uint8), q).astype(np.float32)

    return arr.astype(np.float32) if out_boxes is None else (
        arr.astype(np.float32),
        out_boxes.astype(np.float32),
    )
