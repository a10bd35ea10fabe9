"""A stand-in for PyMuPDF (``fitz``) that serves the port's renders, so the
JAX package's own PDF wrappers (``spine_vision_tpu/io/pdf.py``) run here:
``fitz.open(path)`` parses with ``spine_vision_torch/io/pdf_parse.py`` and a
page's ``get_pixmap(matrix=Matrix(z, z))`` renders at zoom ``z`` with
``io/pdf_render.py``, as RGBA (an opaque alpha channel, which the JAX
wrappers drop with ``[..., :3]``)."""

import types

import numpy as np

from spine_vision_torch.io.pdf_parse import Document
from spine_vision_torch.io.pdf_render import render_page


class _Pixmap:
    def __init__(self, rgb: np.ndarray):
        rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=2)
        self.samples = rgba.tobytes()
        self.height, self.width, self.n = rgba.shape


class _Page:
    def __init__(self, doc: Document, page: dict):
        self.doc, self.page = doc, page

    def get_pixmap(self, matrix):
        if matrix.a != matrix.d:
            raise ValueError("the stub renders square zooms only")
        return _Pixmap(render_page(self.doc, self.page, zoom=matrix.a))


class _Doc:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.doc = Document(f.read())
        self.pages = [_Page(self.doc, p) for p in self.doc.pages()]
        self.page_count = len(self.pages)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __iter__(self):
        return iter(self.pages)

    def __getitem__(self, i: int) -> _Page:
        return self.pages[i]


def fitz_stub() -> types.ModuleType:
    mod = types.ModuleType("fitz")
    mod.Matrix = lambda a, d: types.SimpleNamespace(a=a, d=d)
    mod.open = _Doc
    return mod
