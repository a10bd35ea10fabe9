"""Fused two-stage study inference: localization -> crop -> grading.

Counterpart of ``spine_vision_tpu/infer/pipeline.py`` (``StudyInferencePipeline``
and ``loc_and_crop``). One call runs the whole per-study graph on the device
over a batch of studies:

    padded sagittal slices [N, S, Hp, Wp]
      -> per-slice min-max normalise (masked to the true extent)
      -> dynamic-extent resize to the localization input (512^2)
      -> ConvNeXt localization forward             [N*S, L, 2] coords
      -> spine-tangent rotation angles             [N*S, L]
      -> mm -> pixel crop deltas from per-slice spacing
      -> fused rotate+crop+normalise+letterbox     [N*S, L, ch, cw] uint8
      -> [T2, T1, T2] channel assembly             [N*L, ch, cw, 3]
      -> ResNet multi-task grading forward         {task: [N, L, C]}

Batches pad to a power of two of studies (dummy rows are 1x1 slices with
spacing 1.0 whose results are dropped), as in the JAX package.
``StudyInferencePipeline.from_checkpoints`` builds both models from the
trainers' run directories (``state.pt``, the model alone).
``study_input_from_paths`` builds a study's input from its two series on
disk (``io/series.py``).
``SeriesCropPipeline`` runs the localization and crop stages alone over a
batch of series slices, for building classification sets; without a
localization model it crops around fixed fallback centres.

``StudyInferencePipeline.run`` may be called from several threads (two
servers on one watch directory share one pipeline): on CUDA its page-locked
host buffer is reused across calls, so a lock held from the packing to the
fetch of the results keeps a second call from refilling the buffer while the
first call's upload is still queued. ``SeriesCropPipeline.run`` packs into a
fresh buffer each call and needs none.

Both pipelines take ``mesh=data_parallel_mesh()`` (``parallel/mesh.py``), a
list of local devices, as the JAX package takes a ``("data",)`` mesh: they
keep one model replica per device, pad the batch to a multiple of the
device count, queue every shard's graph on its device before any fetch, so
the devices overlap, then gather to the host and drop the padding. The
shards upload from slices of the one packed host buffer, under the same
lock. ``mesh=None`` is the one-device path.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from spine_vision_torch.core.tasks import (
    TaskConfig,
    compute_predictions_for_tasks,
    compute_probabilities_for_tasks,
    get_tasks,
)
from spine_vision_torch.device import resolve_device
from spine_vision_torch.models.classifier import Classifier, CoordinateRegressor
from spine_vision_torch.ops.crop import crop_ivd_regions
from spine_vision_torch.ops.geometry import mm_to_pixels, rotation_angles
from spine_vision_torch.ops.image import imagenet_normalize, resize_dynamic
from spine_vision_torch.train.checkpoint import load_model_state

logger = logging.getLogger("spine_vision_torch")

# Approximate normalised (x, y) IVD centres L1/L2..L5/S1 used when there is
# no localization model.
DEFAULT_IVD_CENTERS_XY = np.array(
    [(0.5, 0.25), (0.5, 0.35), (0.5, 0.45), (0.5, 0.55), (0.5, 0.65)], dtype=np.float32
)


def _fallback_centers(num_levels: int) -> np.ndarray:
    """Centre-column fallback disc centres ``[L, 2]`` for any level count."""
    if num_levels == len(DEFAULT_IVD_CENTERS_XY):
        return DEFAULT_IVD_CENTERS_XY
    y = np.linspace(0.25, 0.65, num_levels, dtype=np.float32)
    return np.stack([np.full(num_levels, 0.5, np.float32), y], axis=-1)


def _bucket_count(n: int, bucket: bool, multiple: int = 1) -> int:
    """Padded batch size: the next power of two when bucketing, then rounded
    up to a multiple of the device count."""
    if bucket and n > 0:
        n = 1 << (n - 1).bit_length()
    if multiple > 1 and n > 0:
        n = -(-n // multiple) * multiple
    return n


def _mesh_devices(mesh: Any | None, device: str | torch.device) -> tuple[torch.device, ...]:
    """The devices a pipeline runs on: ``mesh``'s (each resolved), or
    ``(device,)``. A batch pads to a multiple of their count."""
    if mesh is None:
        return (resolve_device(device),)
    devices = tuple(resolve_device(d) for d in mesh)
    if not devices:
        raise ValueError("a pipeline's mesh needs at least one device")
    return devices


def _replicate_model(model: torch.nn.Module | None, devices: tuple[torch.device, ...]) -> list:
    """One eval-mode copy of ``model`` per device: the model itself on the
    first device, copies on the others."""
    if model is None:
        return [None] * len(devices)
    first = model.to(devices[0]).eval()
    return [first] + [copy.deepcopy(first).to(d).eval() for d in devices[1:]]


def _on(device: torch.device):
    """The device's context: kernels launch on the current CUDA device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _place_slice(
    dst: np.ndarray, hw_row: np.ndarray, arr: np.ndarray, padded_hw: tuple[int, int]
) -> None:
    """Copy one slice into its padded buffer row and record its extent."""
    h, w = arr.shape
    hp, wp = padded_hw
    if h > hp or w > wp:
        raise ValueError(f"slice {arr.shape} exceeds padded_hw {padded_hw}")
    dst[:h, :w] = arr
    hw_row[:] = (h, w)


@dataclass(frozen=True)
class StudyPipelineConfig:
    """Static configuration of the study graph (the JAX package's defaults)."""

    loc_image_size: tuple[int, int] = (512, 512)
    crop_size: tuple[int, int] = (256, 256)
    crop_delta_mm: tuple[float, float, float, float] = (55.0, 15.0, 17.5, 20.0)
    crop_mode: str = "horizontal"  # "horizontal" | "rotated"
    last_disc_angle_boost: float = 1.0
    num_levels: int = 5
    padded_hw: tuple[int, int] = (1024, 1024)
    bucket_batches: bool = True


@dataclass
class StudyInput:
    """One study: middle sagittal slices per series with their spacing."""

    t1_slice: np.ndarray  # [h, w] raw intensities
    t2_slice: np.ndarray
    t1_spacing: tuple[float, float]  # (row, col) mm/px
    t2_spacing: tuple[float, float]
    study_id: str = ""


def study_input_from_paths(
    t1_path: Path, t2_path: Path, study_id: str = "", device: str | torch.device = "cuda"
) -> StudyInput:
    """A StudyInput from two series on disk (DICOM directory, .mha, .nii(.gz),
    .nrrd): each series' 0.3 mm isotropic middle sagittal slice and its
    spacing (``io/series.py``, the in-plane products on ``device``).
    ``study_id`` defaults to the T2 path's stem.

    The two series decode on two threads, as in the JAX package: the file
    reads, inflation and C++ entropy decode overlap; the products queue on
    the device either way. Both results are read, so the first error raises.
    """
    from concurrent.futures import ThreadPoolExecutor

    from spine_vision_torch.io.series import prepare_series_slice

    dev = resolve_device(device)
    with ThreadPoolExecutor(max_workers=2) as pool:
        t1_future = pool.submit(prepare_series_slice, t1_path, device=dev)
        t2_future = pool.submit(prepare_series_slice, t2_path, device=dev)
        t1_slice, t1_spacing = t1_future.result()
        t2_slice, t2_spacing = t2_future.result()
    return StudyInput(
        t1_slice=t1_slice,
        t2_slice=t2_slice,
        t1_spacing=t1_spacing,
        t2_spacing=t2_spacing,
        study_id=study_id or Path(t2_path).stem,
    )


@dataclass
class StudyResult:
    """Per-study outputs (host numpy)."""

    study_id: str
    coords: np.ndarray  # [S, L, 2]
    angles: np.ndarray  # [S, L]
    crops: np.ndarray | None  # [S, L, ch, cw] uint8, None unless fetched
    logits: dict[str, np.ndarray]  # task -> [L, C]
    predictions: dict[str, np.ndarray] = field(default_factory=dict)
    probabilities: dict[str, np.ndarray] = field(default_factory=dict)


def _normalize_slices_masked(
    flat: torch.Tensor, flat_hw: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slice min-max to [0, 255] over the true extent only.

    Returns (normalised ``[M, Hp, Wp]``, valid mask ``[M, Hp, Wp]``)."""
    _, hp, wp = flat.shape
    rows = torch.arange(hp, device=flat.device)[None, :, None]
    cols = torch.arange(wp, device=flat.device)[None, None, :]
    valid = (rows < flat_hw[:, 0, None, None]) & (cols < flat_hw[:, 1, None, None])
    big = 3.4e38
    smin = torch.where(valid, flat, big).amin(dim=(1, 2), keepdim=True)
    smax = torch.where(valid, flat, -big).amax(dim=(1, 2), keepdim=True)
    inv = torch.where(
        smax > smin, 1.0 / torch.clamp(smax - smin, min=1e-12), torch.zeros_like(smax)
    )
    return torch.where(valid, (flat - smin) * inv * 255.0, torch.zeros_like(flat)), valid


def loc_and_crop(
    loc_model: CoordinateRegressor | None,
    cfg: StudyPipelineConfig,
    flat: torch.Tensor,  # [M, Hp, Wp] f32 raw intensities
    flat_hw: torch.Tensor,  # [M, 2] int
    flat_spacing: torch.Tensor,  # [M, 2] f32 (row, col) mm/px
    centers_override: torch.Tensor | None = None,  # [M, L, 2]: skips the forward
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Localization + fused crop over a flat batch of slices.

    Returns (coords ``[M, L, 2]``, angles ``[M, L]``, crops
    ``[M, L, ch, cw]`` uint8)."""
    m = flat.shape[0]
    flat, _ = _normalize_slices_masked(flat.float(), flat_hw)
    if centers_override is not None:
        coords = centers_override.float()
    else:
        if loc_model is None:
            raise ValueError("loc_and_crop needs a loc_model or centers_override")
        lh, lw = cfg.loc_image_size
        loc_in = resize_dynamic(flat, flat_hw, lh, lw)
        loc_rgb = imagenet_normalize((loc_in[..., None] / 255.0).expand(m, lh, lw, 3))
        coords = loc_model(loc_rgb).float()

    if cfg.crop_mode == "rotated":
        angles = rotation_angles(coords, flat_hw, cfg.last_disc_angle_boost)
    else:
        angles = torch.zeros((m, cfg.num_levels), dtype=torch.float32, device=flat.device)
    delta_mm = torch.tensor(cfg.crop_delta_mm, dtype=torch.float32)
    deltas = mm_to_pixels(delta_mm, flat_spacing)
    ch, cw = cfg.crop_size
    crops = crop_ivd_regions(
        flat, coords, angles, deltas, flat_hw, crop_h=ch, crop_w=cw,
        separable=cfg.crop_mode != "rotated",
    )
    return coords, angles, crops


class SeriesCropPipeline:
    """Batched localization + fused IVD cropping, for building datasets.

    A batch of series slices runs through :func:`loc_and_crop` in one call,
    padded as the study pipeline pads studies. With ``loc_model=None`` the
    fallback centres stand in for the forward. ``loc_model`` is moved to
    ``device`` (CUDA by default; the CPU only when asked for), or replicated
    over ``mesh``'s devices, each of which crops its shard of the batch."""

    def __init__(
        self,
        loc_model: CoordinateRegressor | None,
        config: StudyPipelineConfig | None = None,
        device: str | torch.device = "cuda",
        mesh: Any | None = None,
    ) -> None:
        self.devices = _mesh_devices(mesh, device)
        self.device = self.devices[0]
        self.config = config or StudyPipelineConfig()
        self._loc_replicas = _replicate_model(loc_model, self.devices)
        self.loc_model = self._loc_replicas[0]

    def run(
        self, slices: list[np.ndarray], spacings: list[tuple[float, float]]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Crop a batch of ``[h, w]`` raw-intensity slices with their (row,
        col) mm/px spacings.

        Returns (coords ``[M, L, 2]``, angles ``[M, L]``, crops
        ``[M, L, ch, cw]`` uint8) as host numpy."""
        cfg = self.config
        hp, wp = cfg.padded_hw
        n_real = len(slices)
        m = _bucket_count(n_real, cfg.bucket_batches, len(self.devices))
        flat = np.zeros((m, hp, wp), dtype=np.float32)
        # Dummy rows carry 1x1 extents so the masked normalise stays finite.
        hw = np.ones((m, 2), dtype=np.int32)
        for i, sl in enumerate(slices):
            _place_slice(flat[i], hw[i], np.asarray(sl, dtype=np.float32), cfg.padded_hw)
        spacing = np.ones((m, 2), dtype=np.float32)
        spacing[:n_real] = np.asarray(spacings, dtype=np.float32)
        k = m // len(self.devices)  # rows a device
        outs = []
        with torch.inference_mode():
            for i, (dev, model) in enumerate(zip(self.devices, self._loc_replicas)):
                rows = slice(i * k, (i + 1) * k)
                centers = None
                if model is None:
                    centers = torch.from_numpy(_fallback_centers(cfg.num_levels)).to(
                        dev).expand(k, -1, -1)
                with _on(dev):
                    outs.append(loc_and_crop(
                        model, cfg, torch.from_numpy(flat[rows]).to(dev),
                        torch.from_numpy(hw[rows]).to(dev),
                        torch.from_numpy(spacing[rows]).to(dev), centers_override=centers,
                    ))
            return tuple(
                np.concatenate([out[j].cpu().numpy() for out in outs])[:n_real]
                for j in range(3)
            )


class StudyInferencePipeline:
    """Batched fused localization -> crop -> grading executor.

    The models are moved to ``device`` (CUDA by default; the CPU only when
    asked for), or replicated over ``mesh``'s devices (``parallel/mesh.py::
    data_parallel_mesh``), each of which runs its shard of the batch."""

    def __init__(
        self,
        loc_model: CoordinateRegressor,
        cls_model: Classifier,
        config: StudyPipelineConfig | None = None,
        tasks: list[TaskConfig] | None = None,
        device: str | torch.device = "cuda",
        mesh: Any | None = None,
    ) -> None:
        self.devices = _mesh_devices(mesh, device)
        self.device = self.devices[0]
        self.config = config or StudyPipelineConfig()
        self._replicas = list(zip(_replicate_model(loc_model, self.devices),
                                  _replicate_model(cls_model, self.devices)))
        self.loc_model, self.cls_model = self._replicas[0]
        self.tasks = tasks if tasks is not None else get_tasks()
        self._pinned: dict[tuple[int, ...], torch.Tensor] = {}
        self._run_lock = threading.Lock()

    @classmethod
    def from_checkpoints(
        cls,
        loc_checkpoint: Path,
        cls_checkpoint: Path,
        loc_backbone: str = "convnext_base",
        cls_backbone: str = "resnet18",
        config: StudyPipelineConfig | None = None,
        tasks: list[TaskConfig] | None = None,
        dtype: torch.dtype = torch.bfloat16,
        use_pallas: bool | None = None,
        device: str | torch.device = "cuda",
        mesh: Any | None = None,
    ) -> "StudyInferencePipeline":
        """Both stages from the trainers' run directories (``best_model``,
        say): the models' parameters and BatchNorm statistics, kept in f32
        and computed in ``dtype``, as the JAX package's Flax models are.

        ``use_pallas=None`` runs the kernels on CUDA and the plain path on the
        CPU; a checkpoint trained in any ``use_pallas`` mode loads in any.
        ``mesh`` (a device list) replicates both models over its devices,
        which then take the place of ``device``."""
        dev = _mesh_devices(mesh, device)[0]
        if use_pallas is None:
            use_pallas = dev.type == "cuda"
        config = config or StudyPipelineConfig()
        task_list = tasks if tasks is not None else get_tasks()
        kw = {"dtype": dtype, "device": dev, "use_pallas": use_pallas,
              "param_dtype": torch.float32}
        loc_model = CoordinateRegressor(loc_backbone, num_levels=config.num_levels, **kw)
        load_model_state(Path(loc_checkpoint), loc_model)
        cls_model = Classifier(cls_backbone, tasks=tuple(task_list), **kw)
        load_model_state(Path(cls_checkpoint), cls_model)
        logger.info("Loaded pipeline: loc=%s (%s), cls=%s (%s)", loc_backbone, loc_checkpoint,
                    cls_backbone, cls_checkpoint)
        return cls(loc_model, cls_model, config=config, tasks=task_list, device=dev, mesh=mesh)

    def _host_buffer(self, shape: tuple[int, ...]) -> np.ndarray:
        """Zeroed f32 host buffer for the packed slices: page-locked and
        reused across calls when the device is CUDA, so the upload is one
        asynchronous copy."""
        if self.device.type != "cuda":
            return np.zeros(shape, dtype=np.float32)
        buf = self._pinned.get(shape)
        if buf is None:
            buf = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            self._pinned[shape] = buf
        arr = buf.numpy()
        arr.fill(0.0)
        return arr

    def _fused(
        self, slices: torch.Tensor, hw: torch.Tensor, spacing: torch.Tensor,
        include_crops: bool = True, replica: int = 0,
    ) -> dict:
        """The study graph on one device's batch, with its ``replica`` of the
        models."""
        cfg = self.config
        loc_model, cls_model = self._replicas[replica]
        n, s, hp, wp = slices.shape
        coords, angles, crops = loc_and_crop(
            loc_model, cfg, slices.reshape(n * s, hp, wp).float(),
            hw.reshape(n * s, 2), spacing.reshape(n * s, 2),
        )
        ch, cw = cfg.crop_size
        crops = crops.reshape(n, s, cfg.num_levels, ch, cw)
        # [T2, T1, T2] channel assembly.
        t1 = crops[:, 0].float() / 255.0
        t2 = crops[:, 1].float() / 255.0
        rgb = torch.stack([t2, t1, t2], dim=-1)
        cls_in = imagenet_normalize(rgb.reshape(n * cfg.num_levels, ch, cw, 3))
        logits = {
            k: v.reshape(n, cfg.num_levels, *v.shape[1:]).float()
            for k, v in cls_model(cls_in).items()
        }
        out = {
            "coords": coords.reshape(n, s, cfg.num_levels, 2),
            "angles": angles.reshape(n, s, cfg.num_levels),
            "logits": logits,
        }
        if include_crops:
            out["crops"] = crops
        return out

    def _pack(self, studies: list[StudyInput]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        hp, wp = self.config.padded_hw
        n = _bucket_count(len(studies), self.config.bucket_batches, len(self.devices))
        slices = self._host_buffer((n, 2, hp, wp))
        # Dummy rows carry 1x1 extents so the masked normalise stays finite.
        hw = np.ones((n, 2, 2), dtype=np.int32)
        spacing = np.ones((n, 2, 2), dtype=np.float32)
        for i, study in enumerate(studies):
            for j, (sl, sp) in enumerate(
                ((study.t1_slice, study.t1_spacing), (study.t2_slice, study.t2_spacing))
            ):
                _place_slice(
                    slices[i, j], hw[i, j], np.asarray(sl, dtype=np.float32),
                    self.config.padded_hw,
                )
                spacing[i, j] = sp
        return slices, hw, spacing

    def run(self, studies: list[StudyInput], fetch_crops: bool = True) -> list[StudyResult]:
        """Run the graph on a batch of studies and decode on the host.

        ``fetch_crops=False`` leaves the crop tensor on the device (on a mesh,
        each device's shard); ``StudyResult.crops`` is then None."""
        # The lock spans the packing, the asynchronous uploads and the fetch
        # that waits for them: the next call (from any thread) refills the
        # reused host buffer only once this call's copies have finished.
        with self._run_lock, torch.inference_mode():
            slices, hw, spacing = self._pack(studies)
            k = len(slices) // len(self.devices)  # studies a device
            outs = []
            for i, dev in enumerate(self.devices):  # every shard queued before a fetch
                rows = slice(i * k, (i + 1) * k)
                with _on(dev):
                    outs.append(self._fused(
                        torch.from_numpy(slices[rows]).to(dev, non_blocking=True),
                        torch.from_numpy(hw[rows]).to(dev),
                        torch.from_numpy(spacing[rows]).to(dev),
                        include_crops=fetch_crops, replica=i,
                    ))

            def gather(key: str) -> np.ndarray:
                return np.concatenate([out[key].cpu().numpy() for out in outs])

            host = {
                "coords": gather("coords"),
                "angles": gather("angles"),
                "logits": {k: np.concatenate([out["logits"][k].cpu().numpy() for out in outs])
                           for k in outs[0]["logits"]},
            }
            if fetch_crops:
                host["crops"] = gather("crops")
        results = []
        for i, study in enumerate(studies):
            logits = {k: v[i] for k, v in host["logits"].items()}
            results.append(
                StudyResult(
                    study_id=study.study_id,
                    coords=host["coords"][i],
                    angles=host["angles"][i],
                    crops=host["crops"][i] if fetch_crops else None,
                    logits=logits,
                    predictions=compute_predictions_for_tasks(logits, self.tasks),
                    probabilities=compute_probabilities_for_tasks(logits, self.tasks),
                )
            )
        return results
