"""Visualization primitives: figure saving, colors, prediction decoding.

Counterpart of ``spine_vision_tpu/viz/base.py``. Matplotlib runs headless
(Agg); ``save_figure`` supports 'image' (PNG), 'html' (PNG + minimal HTML
wrapper) and 'browser' (best-effort open) output modes.
``load_classification_original_images`` reads its PNGs with ``data/png.py``
and resizes with :func:`resize_linear_u8`, OpenCV's fixed-point uint8
``INTER_LINEAR``, where the JAX package calls cv2.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np

# Confusion category colors (parity with reference color constants).
CONFUSION_COLORS = {
    "TP": "#2ca02c",
    "TN": "#1f77b4",
    "FP": "#d62728",
    "FN": "#ff7f0e",
}

SPLIT_COLORS = {
    "train": "#1f77b4",
    "val": "#ff7f0e",
    "test": "#2ca02c",
}


def extract_prediction_value(pred: np.ndarray | float | int) -> int:
    """Decode a prediction array to a class index.

    Binary probabilities ([1] or scalar in [0,1]) threshold at 0.5;
    multiclass probability vectors argmax (reference base.py:43-74).
    """
    arr = np.asarray(pred)
    if arr.ndim == 0:
        value = float(arr)
        return int(value > 0.5) if 0.0 <= value <= 1.0 else int(value)
    arr = arr.reshape(-1)
    if arr.size == 1:
        value = float(arr[0])
        return int(value > 0.5) if 0.0 <= value <= 1.0 else int(value)
    return int(np.argmax(arr))


def save_figure(
    fig: "plt.Figure",
    output_path: Path,
    filename: str,
    output_mode: str = "image",
    dpi: int = 100,
) -> Path:
    """Save a figure per the output mode and close it.

    Returns the saved image path.
    """
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    image_path = output_path / f"{filename}.png"
    fig.savefig(image_path, dpi=dpi, bbox_inches="tight")

    if output_mode in ("html", "browser"):
        html_path = output_path / f"{filename}.html"
        html_path.write_text(
            f"<html><body><img src='{image_path.name}'/></body></html>"
        )
        if output_mode == "browser":  # pragma: no cover - interactive only
            import webbrowser

            webbrowser.open(html_path.as_uri())

    plt.close(fig)
    return image_path


def to_display_image(image: np.ndarray) -> np.ndarray:
    """Convert any image array to displayable HWC uint8."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]:
        arr = np.transpose(arr, (1, 2, 0))
    if arr.dtype != np.uint8:
        amin, amax = float(arr.min()), float(arr.max())
        if amax > amin:
            arr = (arr - amin) / (amax - amin) * 255.0
        arr = arr.astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def make_image_grid(
    images: Sequence[np.ndarray],
    titles: Sequence[str] | None = None,
    cols: int = 4,
    cell_size: float = 3.0,
) -> "plt.Figure":
    """Lay out images on a grid of axes (reference base.py:196-220)."""
    n = len(images)
    cols = max(1, min(cols, n))
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * cell_size, rows * cell_size))
    axes = np.atleast_1d(axes).reshape(-1)
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(to_display_image(images[i]), cmap="gray")
            if titles is not None and i < len(titles):
                ax.set_title(str(titles[i]), fontsize=8)
    return fig


def _linear_taps(src: int, dst: int, clamp: bool) -> tuple[np.ndarray, ...]:
    """OpenCV's ``INTER_LINEAR`` taps along one axis (``resize.cpp``): each
    output's two source indices (clamped to the image) and fixed-point
    weights (scaled by 2048, ``INTER_RESIZE_COEF_BITS = 11``). Along x
    (``clamp``) a tap before the first or past the last sample takes that
    sample alone; along y OpenCV keeps the weights and clamps the rows."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        f = np.where((s < 0) | (s >= src - 1), np.float32(0), f)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a uint8
    ``[H, W]`` or ``[H, W, C]`` image, bit for bit: the horizontal pass sums
    ``S * alpha`` in int32, the vertical pass is OpenCV's ``FixedPtCast``,
    ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``."""
    src = np.asarray(img, np.uint8)
    w, h = size
    sh, sw = src.shape[:2]
    if (sh, sw) == (h, w):
        return src.copy()
    x = src.astype(np.int64)
    x0, x1, a0, a1 = _linear_taps(sw, w, clamp=True)
    rows = x[:, x0] * _bcast(a0, x.ndim, 1) + x[:, x1] * _bcast(a1, x.ndim, 1)
    y0, y1, b0, b1 = _linear_taps(sh, h, clamp=False)
    out = (((_bcast(b0, x.ndim, 0) * (rows[y0] >> 4)) >> 16)
           + ((_bcast(b1, x.ndim, 0) * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _bcast(v: np.ndarray, ndim: int, axis: int) -> np.ndarray:
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def load_classification_original_images(
    data_path: Path,
    metadata_list: list[dict[str, Any]],
    output_size: tuple[int, int] = (256, 256),
) -> list[np.ndarray]:
    """Reconstruct [T2, T1, T2] display images from metadata: the crops'
    gray PNGs (``data/png.py``, cv2's ``IMREAD_GRAYSCALE``) stacked and
    resized as cv2's ``INTER_LINEAR`` resizes them."""
    from spine_vision_torch.data.datasets import construct_3channel
    from spine_vision_torch.data.png import read_png

    images: list[np.ndarray] = []
    data_path = Path(data_path)
    for meta in metadata_list:
        source = meta.get("source", "")
        patient = meta.get("patient_id", "")
        ivd = meta.get("ivd", "")
        t1 = data_path / "images" / f"{source}_{patient}_sag_t1_L{ivd}.png"
        t2 = data_path / "images" / f"{source}_{patient}_sag_t2_L{ivd}.png"
        t1_arr = read_png(t1, mode="gray") if t1.exists() else None
        t2_arr = read_png(t2, mode="gray") if t2.exists() else None
        if t1_arr is None and t2_arr is None:
            images.append(np.zeros((*output_size, 3), dtype=np.uint8))
            continue
        rgb = construct_3channel(t2_arr, t1_arr)
        h, w = output_size
        images.append(resize_linear_u8(rgb, (w, h)))
    return images
