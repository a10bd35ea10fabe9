"""OCR engine for report parsing: text detection, rectification, recognition.

Counterpart of ``spine_vision_tpu/data/phenikaa/ocr.py``. A page batch takes
one detector forward, one rectification of every box of every page, and one
recognizer forward; the host thresholds the probability maps into boxes
(``models/textdet.py``) and decodes the CTC logits (``models/textrec.py``).
The patches stay on the device between rectification and recognition.

Both nets load the JAX package's shipped weights by default
(``<weights_dir>/ocr_{detector,recognizer}.npz``, read as data through
``models/convert.py::load_variables_npz``); explicit ``variables`` (a Flax
tree ``{"params": ..., "batch_stats": ...}``) override them, and missing
weights raise. Every class takes ``device="cuda"`` and raises without a card
unless asked for the CPU.

Files: PNG pages (``data/png.py``, cv2's ``IMREAD_COLOR`` read) and JPEG
pages, baseline or progressive (``io/jpeg.py``, Pillow's ``convert("RGB")``
read). A PDF's first page is rendered by ``io/pdf.py`` (the port's own
renderer, where the JAX package calls PyMuPDF) at ``pdf_dpi``, RGB as
PyMuPDF's pixmap; a page tree with no pages gives ``[]``. Other raster
formats (TIFF, ...) raise ``NotImplementedError`` naming ROADMAP Queue 1
item 13, before any decode, and so does a PDF feature the renderer lacks,
through ``extract`` too, so a missing decoder never reads as an empty page;
a corrupt PDF, PNG or JPEG gives a warning and ``[]``, as in the JAX
package.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Protocol

import numpy as np
import torch

from spine_vision_torch.data.png import read_png
from spine_vision_torch.device import resolve_device
from spine_vision_torch.io.jpeg import read_jpeg
from spine_vision_torch.io.pdf import pdf_first_page_to_array
from spine_vision_torch.models.convert import load_flax_variables, load_variables_npz
from spine_vision_torch.models.textdet import TextDetectionNet, extract_boxes_from_probmap
from spine_vision_torch.models.textrec import TextRecognitionNet, ctc_greedy_decode
from spine_vision_torch.ops.warp import rectify_polygons

logger = logging.getLogger("spine_vision_torch")


# The shipped weights, read as data from the JAX package by path.
DEFAULT_WEIGHTS_DIR = Path(__file__).resolve().parents[3] / "spine_vision_tpu" / "weights"


class Detector(Protocol):
    """Text detector protocol: image -> [N, 4, 2] polygons."""

    def detect(self, image: np.ndarray) -> np.ndarray: ...


class Recognizer(Protocol):
    """Text recognizer protocol: patches [N, h, w] -> N strings."""

    def recognize_batch(self, patches: np.ndarray | torch.Tensor) -> list[str]: ...


def _load_net(net: torch.nn.Module, variables: Any | None, weights_dir: Path, name: str):
    if variables is None:
        path = Path(weights_dir) / f"{name}.npz"
        if not path.exists():
            raise FileNotFoundError(f"OCR weights not found: {path}")
        logger.info("Loading OCR weights: %s", path)
        variables = load_variables_npz(path)
    load_flax_variables(net, variables["params"], variables.get("batch_stats"))
    return net.eval()


def _to_gray_f32(image: np.ndarray) -> np.ndarray:
    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[..., :3].astype(np.float32).mean(axis=-1)
    return arr.astype(np.float32)


def _pad_to_multiple_2d(arr: np.ndarray, multiple: int, value: float = 0.0) -> np.ndarray:
    h, w = arr.shape
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        arr = np.pad(arr, ((0, ph), (0, pw)), constant_values=value)
    return arr


class TextDetector:
    """DB-style detector (``TextDetectionNet``) over page batches."""

    def __init__(
        self,
        variables: Any | None = None,
        weights_dir: Path = DEFAULT_WEIGHTS_DIR,
        input_multiple: int = 32,
        shape_bucket: int = 256,
        threshold: float = 0.3,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.model = _load_net(
            TextDetectionNet(device=self.device), variables, weights_dir, "ocr_detector"
        )
        # Pages pad to a multiple of this with white: the padding changes the
        # map near page edges, so it is the JAX package's.
        self.shape_bucket = max(shape_bucket, input_multiple)
        self.threshold = threshold

    def prepare(self, images: list[np.ndarray]) -> np.ndarray:
        """The net's input ``[P, H, W]`` on the host: gray / 255, each page
        padded with white (1.0; a black band reads as a text stroke) to
        multiples of ``shape_bucket``, then to the batch's largest shape."""
        grays = [
            _pad_to_multiple_2d(_to_gray_f32(im) / 255.0, self.shape_bucket, value=1.0)
            for im in images
        ]
        hmax = max(g.shape[0] for g in grays)
        wmax = max(g.shape[1] for g in grays)
        stacked = np.ones((len(grays), hmax, wmax), dtype=np.float32)
        for i, g in enumerate(grays):
            stacked[i, : g.shape[0], : g.shape[1]] = g
        return stacked

    @torch.inference_mode()
    def probability_maps(self, images: list[np.ndarray]) -> np.ndarray:
        """``[P, H/2, W/2]`` f32 maps of a page batch: one upload, one
        forward, one fetch."""
        batch = torch.from_numpy(self.prepare(images)).to(self.device)[..., None]
        return self.model(batch)[..., 0].cpu().numpy()

    def detect(self, image: np.ndarray) -> np.ndarray:
        """Detect text regions; returns [N, 4, 2] quads (TL TR BR BL)."""
        return self.detect_batch([image])[0]

    def detect_batch(self, images: list[np.ndarray]) -> list[np.ndarray]:
        """Quads of each page of a batch, from one device forward."""
        if not images:
            return []
        return [
            extract_boxes_from_probmap(p, threshold=self.threshold, scale=2.0)
            for p in self.probability_maps(images)
        ]


class TextRecognizer:
    """CTC recognizer (``TextRecognitionNet``) over batches of patches."""

    def __init__(
        self,
        variables: Any | None = None,
        weights_dir: Path = DEFAULT_WEIGHTS_DIR,
        patch_height: int = 32,
        patch_width: int = 256,
        device: str | torch.device = "cuda",
    ) -> None:
        if patch_height != 32:
            raise ValueError(
                "TextRecognitionNet's conv stack pools height 32 -> 1; "
                f"patch_height={patch_height} would silently discard rows"
            )
        self.device = resolve_device(device)
        self.model = _load_net(
            TextRecognitionNet(patch_width=patch_width, device=self.device),
            variables, weights_dir, "ocr_recognizer",
        )
        self.patch_height = patch_height
        self.patch_width = patch_width

    @torch.inference_mode()
    def logits(self, patches: np.ndarray | torch.Tensor) -> np.ndarray:
        """``[N, W/4, C]`` f32 CTC logits of ``[N, 32, W]`` gray patches in
        [0, 255] (host or device), with one fetch."""
        patches = torch.as_tensor(patches).to(device=self.device, dtype=torch.float32)
        if patches.ndim != 3:
            raise ValueError(
                f"recognize_batch expects [N, h, w] grayscale patches, got shape "
                f"{tuple(patches.shape)}"
            )
        if patches.shape[2] != self.patch_width:
            raise ValueError(
                f"patch width {patches.shape[2]} != recognizer patch_width "
                f"{self.patch_width} (the positional embedding is sized for the training width)"
            )
        return self.model((patches / 255.0)[..., None]).cpu().numpy()

    def recognize_batch(self, patches: np.ndarray | torch.Tensor) -> list[str]:
        """Recognize a [N, h, w] batch of rectified text patches."""
        if patches.shape[0] == 0:
            return []
        return ctc_greedy_decode(self.logits(patches))


class DocumentExtractor:
    """Detection -> rectification -> recognition."""

    def __init__(
        self,
        detector: Detector | None = None,
        recognizer: Recognizer | None = None,
        patch_height: int = 32,
        patch_width: int = 256,
        weights_dir: Path = DEFAULT_WEIGHTS_DIR,
        pdf_dpi: int = 200,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.pdf_dpi = pdf_dpi
        self._page_cache: tuple[tuple[str, int], np.ndarray | None] | None = None
        self.detector = detector or TextDetector(weights_dir=weights_dir, device=self.device)
        self.recognizer = recognizer or TextRecognizer(
            weights_dir=weights_dir, patch_height=patch_height, patch_width=patch_width,
            device=self.device,
        )
        self.patch_height = patch_height
        self.patch_width = patch_width

    def rectify_pages(self, images: list[np.ndarray], page_quads: list[np.ndarray]) -> torch.Tensor:
        """Every box of every page (of one page, too) in one rectification
        pass, as ``[N, patch_height, patch_width]`` on the device.

        The pages stack into one tall zero-filled ``[P * Hmax, Wmax]`` image.
        The quads stay in page-local coordinates; each is clamped to its own
        page's extent (a box hanging past its page's edge repeats that page's
        border) and shifted by its page's row offset after the solve.
        """
        counts = [q.shape[0] for q in page_quads]
        hmax = max(im.shape[0] for im in images)
        wmax = max(im.shape[1] for im in images)
        stacked = np.zeros((len(images), hmax, wmax), dtype=np.float32)
        for i, im in enumerate(images):
            g = _to_gray_f32(im)
            stacked[i, : g.shape[0], : g.shape[1]] = g
        all_quads = np.concatenate(page_quads).astype(np.float32)
        row_off = np.repeat(np.arange(len(images), dtype=np.float32) * hmax, counts)
        bounds = np.stack(
            [np.repeat(np.asarray([im.shape[0] - 1 for im in images], np.float32), counts),
             np.repeat(np.asarray([im.shape[1] - 1 for im in images], np.float32), counts)],
            axis=1,
        )
        offsets = np.stack([row_off, np.zeros_like(row_off)], axis=1)
        return rectify_polygons(
            torch.from_numpy(stacked.reshape(-1, wmax)).to(self.device),
            torch.from_numpy(all_quads), self.patch_height, self.patch_width,
            bounds=torch.from_numpy(bounds), offsets=torch.from_numpy(offsets),
        )

    def extract_from_image(self, image: np.ndarray) -> list[str]:
        """OCR an image into text lines (reading order)."""
        return [text for text, _ in self.extract_lines_from_image(image)]

    def extract_lines_from_image(self, image: np.ndarray) -> list[tuple[str, np.ndarray]]:
        """OCR an image into (text, quad) pairs; the quad is the detector's
        ``[4, 2]`` (x, y) TL TR BR BL box, for layout-aware extraction
        (``matching.fuzzy_value_extract_spatial``)."""
        quads = np.asarray(self.detector.detect(image)).reshape(-1, 4, 2)
        if quads.shape[0] == 0:
            return []
        texts = self.recognizer.recognize_batch(self.rectify_pages([image], [quads]))
        return list(zip(texts, quads))

    def extract_from_images(self, images: list[np.ndarray]) -> list[list[str]]:
        """OCR a batch of pages: one detector forward over every page (or
        ``detect`` a page for detectors without ``detect_batch``), one
        rectification of every box, one recognizer forward."""
        if not images:
            return []
        if hasattr(self.detector, "detect_batch"):
            page_quads = self.detector.detect_batch(images)
        else:
            page_quads = [self.detector.detect(im) for im in images]
        page_quads = [np.asarray(q).reshape(-1, 4, 2) for q in page_quads]
        counts = [q.shape[0] for q in page_quads]
        if sum(counts) == 0:
            return [[] for _ in images]
        texts = self.recognizer.recognize_batch(self.rectify_pages(images, page_quads))
        out: list[list[str]] = []
        offset = 0
        for c in counts:
            out.append(texts[offset : offset + c])
            offset += c
        return out

    def extract(self, path: Path) -> list[str]:
        """OCR a report file (a PDF's first page, a PNG or a JPEG). A corrupt or
        unreadable file returns [] with a warning: one bad file must not
        abort a long preprocessing run."""
        return [text for text, _ in self.extract_lines(path)]

    def extract_lines(self, path: Path) -> list[tuple[str, np.ndarray]]:
        """OCR a report file into (text, quad) pairs (the file contract of
        :meth:`extract`)."""
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix not in (".pdf", ".png", ".jpg", ".jpeg"):
            raise NotImplementedError(
                f"{path.name}: the port reads PDF, PNG and JPEG report pages only; "
                "other raster formats wait for a decoder (ROADMAP Queue 1 item 13)"
            )
        try:
            if suffix == ".pdf":
                page = self._render_first_page(path, self.pdf_dpi)
                return [] if page is None else self.extract_lines_from_image(page)
            if suffix == ".png":
                return self.extract_lines_from_image(read_png(path, mode="color"))
            return self.extract_lines_from_image(read_jpeg(path, mode="RGB"))
        except NotImplementedError:
            raise  # a feature the port's decoders lack: never an empty page
        except Exception as exc:  # noqa: BLE001 — isolate bad files
            logger.warning("OCR failed for %s: %s", path, exc)
            return []

    def _render_first_page(self, pdf_path: Path, dpi: int) -> np.ndarray | None:
        """First PDF page at ``dpi``, memoized (size 1) so the crop fast
        path and the full-page fallback do not rasterize the page twice."""
        key = (str(Path(pdf_path).resolve()), dpi)
        if self._page_cache is not None and self._page_cache[0] == key:
            return self._page_cache[1]
        page = pdf_first_page_to_array(pdf_path, dpi=dpi)
        self._page_cache = (key, page)
        return page

    def extract_from_pdf(self, pdf_path: Path, dpi: int | None = None) -> list[str]:
        """OCR the first page of a PDF."""
        page = self._render_first_page(pdf_path, dpi or self.pdf_dpi)
        if page is None:
            return []
        return self.extract_from_image(page)

    def extract_from_pdf_crop(
        self,
        pdf_path: Path,
        crop_region: tuple[int, int, int, int],
        dpi: int | None = None,
    ) -> list[str]:
        """OCR a fixed pixel region of a PDF's first page. The region is in
        200-DPI pixels and is rescaled when the page renders at another DPI."""
        rendered_dpi = dpi or self.pdf_dpi
        page = self._render_first_page(pdf_path, rendered_dpi)
        if page is None:
            return []
        scale = rendered_dpi / 200.0
        x1, y1, x2, y2 = (int(round(c * scale)) for c in crop_region)
        region = page[y1:y2, x1:x2]
        if region.size == 0:
            return []
        return self.extract_from_image(region)
