"""PDF rasterization: not available in the port.

Counterpart of ``spine_vision_tpu/io/pdf.py``, which renders pages with
PyMuPDF when it is importable and raises ``ImportError`` otherwise. The port
never imports PyMuPDF (the card's machine does not have it), so every entry
point raises that ``ImportError``: the JAX package's behaviour wherever
PyMuPDF is missing. Rasterize reports to PNG and use the image path
(``data/phenikaa/ocr.py``). A PDF renderer waits for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _no_renderer() -> ImportError:
    return ImportError(
        "PDF rendering requires PyMuPDF (pymupdf), which spine_vision_torch does not "
        "import (ROADMAP Queue 1 item 13). Pre-rasterize reports to PNG and use the "
        "image path instead."
    )


def pdf_to_arrays(pdf_path: Path, dpi: int = 200) -> list[np.ndarray]:
    """Every page of a PDF as an RGB uint8 array (raises ``ImportError``)."""
    raise _no_renderer()


def pdf_first_page_to_array(pdf_path: Path, dpi: int = 200) -> np.ndarray | None:
    """The first page only (raises ``ImportError``)."""
    raise _no_renderer()


def pdf_to_images(pdf_path: Path, output_dir: Path, dpi: int = 200) -> list[Path]:
    """A PDF's pages as numbered PNG files in ``output_dir`` (raises
    ``ImportError``, from ``pdf_to_arrays``)."""
    from spine_vision_torch.data.png import write_png

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    paths: list[Path] = []
    for i, arr in enumerate(pdf_to_arrays(pdf_path, dpi=dpi)):
        out = output_dir / f"{Path(pdf_path).stem}_page{i + 1}.png"
        write_png(out, arr)
        paths.append(out)
    return paths
