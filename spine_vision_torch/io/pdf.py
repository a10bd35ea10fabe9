"""PDF rasterisation without PyMuPDF.

Counterpart of ``spine_vision_tpu/io/pdf.py``, which renders pages with
PyMuPDF (``page.get_pixmap(matrix=Matrix(dpi / 72, dpi / 72))``, RGB, the
first three channels kept). The port renders them itself: ``io/pdf_parse.py``
reads the file (xref tables and streams, object streams, incremental
updates, repair; the stream filters), ``io/pdf_fonts.py`` the embedded fonts
(TrueType, CFF, Type 3) and ``io/pdf_render.py`` interprets each page's
content onto an RGB uint8 raster on white, its size the page box at ``dpi /
72`` rounded as MuPDF rounds it (an A4 page at 200 dpi is 1654 x 2339), its
scan converter, compositor, image resamplers and CCITT G4 decoder in C++
(``native/src/host_ops.cpp``) beside plain numpy versions (``plain=True``).

A feature the port does not render (encryption, JBIG2, CCITT G3,
non-embedded or Type 1 fonts, shadings, patterns, soft masks, blend modes,
Separation and DeviceN, annotation appearances, ...) raises
``NotImplementedError`` naming ROADMAP Queue 1 item 13, never a blank or
partial page. A damaged file whose objects can be found is repaired as MuPDF
repairs it; one that cannot raises ``pdf_parse.PdfError``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from spine_vision_torch.io.pdf_parse import Document
from spine_vision_torch.io.pdf_render import render_page


def open_pdf(pdf_path: Path) -> Document:
    """The parsed file (its pages through ``Document.pages()``)."""
    return Document(Path(pdf_path).read_bytes())


def pdf_to_arrays(pdf_path: Path, dpi: int = 200, plain: bool = False) -> list[np.ndarray]:
    """Render every page of a PDF to an RGB uint8 array at the given DPI."""
    doc = open_pdf(pdf_path)
    return [render_page(doc, page, dpi, plain=plain) for page in doc.pages()]


def pdf_first_page_to_array(pdf_path: Path, dpi: int = 200,
                            plain: bool = False) -> np.ndarray | None:
    """Render only the first page (``None`` for a page tree with no pages)."""
    doc = open_pdf(pdf_path)
    pages = doc.pages()
    if not pages:
        return None
    return render_page(doc, pages[0], dpi, plain=plain)


def pdf_to_images(pdf_path: Path, output_dir: Path, dpi: int = 200) -> list[Path]:
    """Render a PDF to numbered PNG files in ``output_dir``
    (``{stem}_page{i + 1}.png``, written by ``data/png.py::write_png``)."""
    from spine_vision_torch.data.png import write_png

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    paths: list[Path] = []
    for i, arr in enumerate(pdf_to_arrays(pdf_path, dpi=dpi)):
        out = output_dir / f"{Path(pdf_path).stem}_page{i + 1}.png"
        write_png(out, arr)
        paths.append(out)
    return paths
