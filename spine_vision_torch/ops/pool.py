"""Scatter-free NHWC max pooling: the ResNet stem's ``pool_impl="tpu"``.

Counterpart of ``spine_vision_tpu/ops/pool.py``:

- forward: the maximum over the window's shifted strided views of the input
  padded with -inf;
- backward: for each window offset, in row-major order, the cotangent goes
  to every input element equal to its window's maximum
  (``g * (x_slice == y)``), summed in f32 and cast to the input's dtype.

The tie rule is the JAX custom VJP's: a window with several maximal elements
sends the whole cotangent to each of them. ``F.max_pool2d`` (and the
``pool_impl="flax"`` stem, ``models/resnet.py::stem_pool``) sends it to the
first one only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _out_size(size: int, window: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - window) // stride + 1


def _pad_neg_inf(x: torch.Tensor, padding: tuple[int, int]) -> torch.Tensor:
    ph, pw = padding
    if ph == 0 and pw == 0:
        return x
    low = -torch.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
    return F.pad(x, (0, 0, pw, pw, ph, ph), value=low)


def _window_views(x_pad, window, strides, out_hw):
    """``(i, j, view)`` for every window offset: the padded input's strided
    view that offset reads, ``[B, oh, ow, C]``."""
    (oh, ow), (sh, sw) = out_hw, strides
    for i in range(window[0]):
        for j in range(window[1]):
            yield i, j, x_pad[:, i: i + (oh - 1) * sh + 1: sh, j: j + (ow - 1) * sw + 1: sw]


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        x_pad = _pad_neg_inf(x, padding)
        out_hw = (_out_size(x.shape[1], window[0], strides[0], padding[0]),
                  _out_size(x.shape[2], window[1], strides[1], padding[1]))
        y = None
        for _, _, view in _window_views(x_pad, window, strides, out_hw):
            y = view.clone() if y is None else torch.maximum(y, view)
        ctx.save_for_backward(x, y)
        ctx.geometry = (window, strides, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        window, strides, (ph, pw) = ctx.geometry
        x_pad = _pad_neg_inf(x, (ph, pw))
        (sh, sw), (oh, ow) = strides, y.shape[1:3]
        gf = g.float()
        dx_pad = torch.zeros(x_pad.shape, dtype=torch.float32, device=x.device)
        for i, j, view in _window_views(x_pad, window, strides, (oh, ow)):
            contrib = torch.where(view == y, gf, 0.0)
            dx_pad[:, i: i + (oh - 1) * sh + 1: sh, j: j + (ow - 1) * sw + 1: sw] += contrib
        dx = dx_pad[:, ph: ph + x.shape[1], pw: pw + x.shape[2]]
        return dx.to(x.dtype), None, None, None


def max_pool(
    x: torch.Tensor, window: tuple[int, int] = (3, 3), strides: tuple[int, int] = (2, 2),
    padding: tuple[int, int] = (1, 1),
) -> torch.Tensor:
    """NHWC max pool whose gradient reaches every maximal element of a
    window (see the module docstring)."""
    return _MaxPool.apply(x, tuple(window), tuple(strides), tuple(padding))
