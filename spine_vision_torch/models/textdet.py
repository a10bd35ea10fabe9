"""Text detection network (DB-style segmentation) for report OCR.

Counterpart of ``spine_vision_tpu/models/textdet.py``: a fully convolutional
encoder/decoder predicts a shrunk-text probability map; the boxes come from
the thresholded map on the host (connected components, min-area filter,
unclip, reading order). The components are ``scipy.ndimage``'s, 4-connected,
where the JAX package uses cv2.

The Flax net computes in bf16 (``dtype=jnp.bfloat16``). XLA computes each
bf16 operation in f32 and rounds its result, except where the model casts
that result up to f32 (excess precision, its default): here every
convolution's output goes to the f32 BatchNorm, so only the values the
model casts to bf16 are rounded, the input and each convolution's input and
kernel. The net does the same: ``bf16_input`` where the Flax model casts,
f32 sums of kernels stored in bf16. Rounding each convolution's output as
well (what a bf16 ``F.conv2d`` does) moves the probabilities against the
JAX package's by several times more than the noise of f32 sums in another
order, and boxes with them.

Variables carry the Flax names (``_ConvBlock_<i>/Conv_0``,
``_ConvBlock_<i>/BatchNorm_0``, the head ``Conv_0``), so
``models/convert.py`` fills the net from the JAX package's trees and from
its shipped ``.npz`` weights.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage
from torch import nn

from spine_vision_torch.core.registry import register_model
from spine_vision_torch.models.layers import Conv, FlaxBatchNorm, bf16_input

# 4-connectivity (cv2's connectivity=4).
_FOUR_CONNECTED = ndimage.generate_binary_structure(2, 1)


class _ConvBlock(nn.Module):
    """3x3 "SAME" convolution without bias of the bf16-rounded input (f32
    sums), then Flax's f32 BatchNorm and a ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, device=None,
                 generator: torch.Generator | None = None,
                 param_dtype=torch.bfloat16) -> None:
        super().__init__()
        self.Conv_0 = Conv(in_ch, features, 3, stride, padding="SAME", bias=False,
                           param_dtype=param_dtype, bf16_kernel=True, device=device,
                           generator=generator)
        self.BatchNorm_0 = FlaxBatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(bf16_input(x)), train))


def _up(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling, cropped to ``like``'s spatial shape."""
    up = t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return up[:, : like.shape[1], : like.shape[2]]


@register_model("text_detection")
class TextDetectionNet(nn.Module):
    """FCN text detector: ``[B, H, W, 1]`` f32 -> probability map
    ``[B, H/2, W/2, 1]`` f32.

    Encoder strides 2/2/2/2 at widths (w, 2w, 4w, 8w); a top-down merge back
    to 1/2 resolution with f32 sums; an f32 1x1 head with bias and a sigmoid.
    H and W must be multiples of 16. ``param_dtype=torch.float32`` keeps f32
    master kernels for training (Flax's default; the convolutions round them
    to bf16), and ``forward(x, train=True)`` is Flax's ``apply(...,
    train=True)``: the BatchNorms use and update the batch statistics.
    """

    def __init__(self, width: int = 32, device=None,
                 generator: torch.Generator | None = None,
                 param_dtype=torch.bfloat16) -> None:
        super().__init__()
        w = width
        kw = {"device": device, "generator": generator}
        # (in, out, stride) of _ConvBlock_0..12, in the Flax module's order.
        blocks = ((1, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1),
                  (2 * w, 4 * w, 2), (4 * w, 4 * w, 1), (4 * w, 8 * w, 2), (8 * w, 8 * w, 1),
                  (8 * w, 2 * w, 1), (4 * w, 2 * w, 1), (2 * w, 2 * w, 1), (w, 2 * w, 1),
                  (2 * w, w, 1))
        for i, (cin, cout, stride) in enumerate(blocks):
            setattr(self, f"_ConvBlock_{i}", _ConvBlock(cin, cout, stride,
                                                        param_dtype=param_dtype, **kw))
        self.Conv_0 = Conv(w, 1, 1, dtype=torch.float32, device=device, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        blocks = [getattr(self, f"_ConvBlock_{i}") for i in range(13)]

        def b(i: int, t: torch.Tensor) -> torch.Tensor:
            return blocks[i](t, train)

        x = bf16_input(x)
        c1 = b(1, b(0, x))  # 1/2
        c2 = b(3, b(2, c1))  # 1/4
        c3 = b(5, b(4, c2))  # 1/8
        c4 = b(7, b(6, c3))  # 1/16
        p4 = b(8, c4)
        p3 = b(9, c3) + _up(p4, c3)
        p2 = b(10, c2) + _up(p3, c2)
        p1 = b(11, c1) + _up(p2, c1)
        return torch.sigmoid(self.Conv_0(b(12, p1)))


def extract_boxes_from_probmap(
    prob_map: np.ndarray,
    threshold: float = 0.3,
    min_area: int = 16,
    unclip_ratio: float = 1.3,
    scale: float = 2.0,
) -> np.ndarray:
    """Connected components of the binarized map -> axis-aligned quads.

    DB post-processing on the host: each 4-connected component of at least
    ``min_area`` map pixels gives its bounding box, dilated about its centre
    by ``unclip_ratio`` (the map marks shrunk text kernels) and scaled by
    ``scale`` back to input coordinates.

    Args:
        prob_map: ``[h, w]`` probabilities (the net's output, 1/scale
            resolution).
        threshold: Binarization threshold.
        min_area: Minimum component area in map pixels.
        unclip_ratio: Box dilation factor.
        scale: Upscale factor back to input-image coordinates.

    Returns:
        ``[N, 4, 2]`` float32 quads TL, TR, BR, BL in image coordinates,
        top to bottom, then left to right.
    """
    labels, n = ndimage.label(np.asarray(prob_map) >= threshold, structure=_FOUR_CONNECTED)
    if n == 0:
        return np.zeros((0, 4, 2), dtype=np.float32)
    areas = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    quads = []
    for sl, area in zip(ndimage.find_objects(labels), areas):
        if area < min_area:
            continue
        y1, y2, x1, x2 = sl[0].start, sl[0].stop, sl[1].start, sl[1].stop
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        half_w = (x2 - x1) / 2.0 * unclip_ratio
        half_h = (y2 - y1) / 2.0 * unclip_ratio
        quad = np.array(
            [[cx - half_w, cy - half_h], [cx + half_w, cy - half_h],
             [cx + half_w, cy + half_h], [cx - half_w, cy + half_h]],
            dtype=np.float32,
        )
        quads.append(quad * scale)
    if not quads:
        return np.zeros((0, 4, 2), dtype=np.float32)
    arr = np.stack(quads)
    order = np.lexsort((arr[:, 0, 0], arr[:, 0, 1]))
    return arr[order]
