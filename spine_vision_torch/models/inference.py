"""Timed test-time inference over mixed image inputs.

Counterpart of ``spine_vision_tpu/models/inference.py``. The model holds its
weights, so the functions take the model alone (the JAX ones take the module
and its variables). Each input is made an RGB uint8 image as the JAX
package's PIL calls make it, without PIL:

- a PNG path is decoded by ``data/png.py`` in colour (alpha dropped);
- a uint8 array is taken as it is: ``[H, W]`` gray is repeated to RGB,
  ``[H, W, 4]`` loses its alpha;
- a JPEG (or any other) path raises ``NotImplementedError``: the port has no
  JPEG decoder yet (ROADMAP Queue 1 item 13).

Each image is resized to ``image_size`` by Pillow's default filter for RGB,
bicubic (``data/pillow_resize.py``, Pillow's fixed-point arithmetic), scaled
to [0, 1] and ImageNet-normalised. The forward runs once to warm up, then
once timed, with the device synchronised before the clock stops.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from spine_vision_torch.core.tasks import (
    TaskConfig,
    compute_predictions_for_tasks,
    compute_probabilities_for_tasks,
    get_tasks,
)
from spine_vision_torch.data.pillow_resize import resize
from spine_vision_torch.data.png import read_png
from spine_vision_torch.ops.image import imagenet_normalize

ImageInput = Any  # str | Path | np.ndarray


def _to_uint8_rgb(img: ImageInput, image_size: tuple[int, int]) -> np.ndarray:
    if isinstance(img, (str, Path)):
        path = Path(img)
        if path.suffix.lower() != ".png":
            raise NotImplementedError(
                f"{path.name}: the port decodes PNG images only; JPEG and other formats "
                "wait for a decoder (ROADMAP Queue 1 item 13)"
            )
        rgb = read_png(path, mode="color")
    elif isinstance(img, np.ndarray):
        if img.dtype != np.uint8:
            raise TypeError(f"expected a uint8 image array, got {img.dtype}")
        if img.ndim == 2:
            rgb = np.repeat(img[..., None], 3, axis=-1)
        elif img.ndim == 3 and img.shape[-1] in (3, 4):
            rgb = img[..., :3]
        else:
            raise TypeError(f"expected a [H, W], [H, W, 3] or [H, W, 4] image, got {img.shape}")
    else:
        raise TypeError(f"Unsupported image type: {type(img)}")
    h, w = image_size
    return resize(rgb, (w, h), "bicubic")


def _preprocess_batch(
    images: Sequence[ImageInput], image_size: tuple[int, int], device: torch.device,
) -> tuple[np.ndarray, torch.Tensor]:
    stacked = np.stack([_to_uint8_rgb(img, image_size) for img in images])
    batch = torch.from_numpy(stacked).to(device).float() / 255.0
    return stacked, imagenet_normalize(batch)


def _timed_forward(model: torch.nn.Module, batch: torch.Tensor) -> tuple[Any, float]:
    """The eval-mode forward, run once to warm up and once timed."""
    model.eval()
    device = batch.device

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        model(batch)
        sync()
        start = time.perf_counter()
        out = model(batch)
        sync()
    return out, (time.perf_counter() - start) * 1000


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def classifier_test_inference(
    model: torch.nn.Module, images: Sequence[ImageInput],
    image_size: tuple[int, int] = (224, 224), tasks: list[TaskConfig] | None = None,
) -> dict[str, Any]:
    """Timed multi-task forward of a ``Classifier`` over image inputs:
    logits, predictions and probabilities per task, the resized uint8
    images, the time in ms and the device."""
    tasks = tasks if tasks is not None else get_tasks()
    device = _device_of(model)
    raw, batch = _preprocess_batch(images, image_size, device)
    logits, ms = _timed_forward(model, batch)
    logits_np = {k: v.float().cpu().numpy() for k, v in logits.items()}
    return {
        "logits": logits_np,
        "predictions": compute_predictions_for_tasks(logits_np, tasks),
        "probabilities": compute_probabilities_for_tasks(logits_np, tasks),
        "images": raw,
        "inference_time_ms": ms,
        "num_images": len(images),
        "device": str(device),
    }


def regressor_test_inference(
    model: torch.nn.Module, images: Sequence[ImageInput],
    image_size: tuple[int, int] = (512, 512),
) -> dict[str, Any]:
    """Timed forward of a ``CoordinateRegressor``: normalised coordinates
    and pixel coordinates in the resized frame."""
    device = _device_of(model)
    raw, batch = _preprocess_batch(images, image_size, device)
    coords, ms = _timed_forward(model, batch)
    coords = coords.float().cpu().numpy()
    h, w = image_size
    return {
        "coordinates": coords,
        "pixel_coordinates": coords * np.asarray([w, h], dtype=np.float32),
        "images": raw,
        "inference_time_ms": ms,
        "num_images": len(images),
        "device": str(device),
    }
