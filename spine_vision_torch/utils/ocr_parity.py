"""The port's OCR held to a record of the JAX package's.

A record is a directory of uint8 gray PNG pages and a ``manifest.json``
(``tests/fixtures/torch_ocr``, written by its ``generate.py``): for each page
the rendered ground truth and the JAX package's ``DocumentExtractor``
output with the shipped weights (quads, texts), plus its threshold ties, the
map pixels within 0.01 of the 0.3 threshold with JAX's decision there.
``bench_*`` pages are read as one batch (``extract_from_images``), report
pages one file each (``extract_lines``).

:func:`check_against_record` runs the extractor's user path on the pages
and holds it to the record:

- boxes: the extractor's own map, thresholded with JAX's decision at the
  tie pixels, gives the record's box count and every quad within
  ``QUAD_TOL_PX`` on every page. At a tie pixel two correct implementations
  straddle the threshold (f32 sums in another order move the map by a few
  1e-3), so the user path's own boxes may differ there: such pages are
  reported, and their lines are paired by quad;
- lines: the CER of the user path's lines against the record's, over the
  lines of boxes within ``QUAD_TOL_PX`` of a record box, at most
  ``CER_BOUND``;
- reports: name, birthday and ID recovered by ``matching.fuzzy_value_extract``
  from each report page's lines, as the JAX package's trained-weights tests
  do.

It also gives, unchecked, the CER of the port's and of the record's lines
against the rendered ground truth (each page's lines joined in reading
order).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from spine_vision_torch.data.png import read_png
from spine_vision_torch.data.phenikaa import (
    BIRTHDAY_FIELD_PATTERN,
    ID_FIELD_PATTERN,
    NAME_FIELD_PATTERN,
)
from spine_vision_torch.data.phenikaa.matching import (
    ascii_fold,
    fuzzy_match_score,
    fuzzy_value_extract,
)
from spine_vision_torch.models.textdet import extract_boxes_from_probmap
from spine_vision_torch.train.ocr import character_error_rate

QUAD_TOL_PX = 2.0
# Several times the gap of two correct implementations: a character now and
# then where two logits nearly tie (chip_smoke.py's ocr phase prints it).
CER_BOUND = 5e-3
# The field-match score each report page must reach (the JAX package's
# tests: 80 on the clean page, 75 on the degraded one).
FIELD_SCORE = {"report_clean.png": 80, "report_degraded.png": 75}


@dataclass
class RecordPage:
    file: str
    path: Path
    image: np.ndarray  # uint8 [H, W]
    truth: dict
    jax: dict


def load_record(directory: Path, files: list[str] | None = None) -> list[RecordPage]:
    """The record's pages (all, or those named in ``files``), read with
    ``data/png.py``."""
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    return [
        RecordPage(p["file"], directory / p["file"], read_png(directory / p["file"], mode="gray"),
                   p["truth"], p["jax"])
        for p in manifest["pages"] if files is None or p["file"] in files
    ]


def resolve_ties(prob_map: np.ndarray, ties: list) -> np.ndarray:
    """``prob_map`` with JAX's decision (1.0 or 0.0) at its tie pixels."""
    resolved = np.array(prob_map, dtype=np.float32)
    if ties:
        ys, xs, decisions = np.asarray(ties).T
        resolved[ys, xs] = decisions
    return resolved


def _quad_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest corner distance in pixels of two equal-length quad lists
    (inf when their lengths differ)."""
    if len(got) != len(want):
        return float("inf")
    if len(got) == 0:
        return 0.0
    return float(np.abs(np.asarray(got) - np.asarray(want).reshape(-1, 4, 2)).max())


def _pair_lines(quads, texts, record) -> list[tuple[str, str]]:
    """(port text, record text) for each record box with a port box within
    ``QUAD_TOL_PX``."""
    pairs = []
    for want_quad, want_text in zip(np.asarray(record["quads"]).reshape(-1, 4, 2),
                                    record["texts"]):
        gaps = [np.abs(np.asarray(q) - want_quad).max() for q in quads]
        if gaps and min(gaps) <= QUAD_TOL_PX:
            pairs.append((texts[int(np.argmin(gaps))], want_text))
    return pairs


def report_fields(texts: list[str], score: float) -> dict:
    """Name, birthday and ID from a report's lines, with the field patterns
    and window lengths of the JAX package's trained-weights tests."""
    return {
        "name": fuzzy_value_extract(texts, NAME_FIELD_PATTERN, score, window_length=3),
        "birthday": fuzzy_value_extract(texts, BIRTHDAY_FIELD_PATTERN, score, window_length=2),
        "id": fuzzy_value_extract(texts, ID_FIELD_PATTERN, score, window_length=2),
    }


def fields_recovered(got: dict, truth: dict, score: float) -> bool:
    """The name within ``score`` (folded partial ratio), the birth year in
    the birthday, the report ID in the ID."""
    return (
        got["name"] is not None
        and fuzzy_match_score(ascii_fold(got["name"]), ascii_fold(truth["name"])) >= score
        and got["birthday"] is not None and truth["birthday"].split("/")[-1] in got["birthday"]
        and got["id"] is not None and truth["id"] in got["id"].replace(" ", "")
    )


def check_against_record(extractor, pages: list[RecordPage]) -> dict:
    """Run ``extractor`` (a ``DocumentExtractor`` with its own
    ``detector.probability_maps``) on ``pages`` and hold it to the record.

    Returns the figures (``boxes``, ``boxes_record``, ``tie_pages``,
    ``max_quad_px``, ``cer_vs_record``, ``cer_truth``, ``cer_truth_record``,
    ``fields``) and ``failures``, a list of what broke the checks (empty
    when all hold).
    """
    bench = [p for p in pages if p.file.startswith("bench_")]
    reports = [p for p in pages if not p.file.startswith("bench_")]
    runs = []  # (page, port quads, port texts, port map)
    if bench:
        images = [p.image for p in bench]
        texts = extractor.extract_from_images(images)
        maps = extractor.detector.probability_maps(images)
        quads = [extract_boxes_from_probmap(m) for m in maps]
        runs += list(zip(bench, quads, texts, maps))
    for page in reports:
        lines = extractor.extract_lines(page.path)
        quads = np.asarray([q for _, q in lines], np.float32).reshape(-1, 4, 2)
        runs.append((page, quads, [t for t, _ in lines],
                     extractor.detector.probability_maps([page.image])[0]))

    failures, tie_pages, pairs, fields = [], [], [], {}
    max_gap = 0.0
    truth_port, truth_record, truth_texts = [], [], []
    for page, quads, texts, prob_map in runs:
        if len(quads) != len(texts):
            failures.append(f"{page.file}: {len(texts)} lines from {len(quads)} boxes")
        resolved = extract_boxes_from_probmap(resolve_ties(prob_map, page.jax["ties"]))
        gap = _quad_gap(resolved, page.jax["quads"])
        max_gap = max(max_gap, gap)
        if gap > QUAD_TOL_PX:
            failures.append(f"{page.file}: {len(resolved)} boxes (ties resolved) against the "
                            f"record's {len(page.jax['quads'])}, quads {gap:.2f} px apart")
        if _quad_gap(quads, page.jax["quads"]) > QUAD_TOL_PX:
            tie_pages.append(page.file)
        pairs += _pair_lines(quads, texts, page.jax)
        truth_port.append(" ".join(texts))
        truth_record.append(" ".join(page.jax["texts"]))
        truth_texts.append(" ".join(page.truth["texts"]))
        if "fields" in page.truth:
            score = FIELD_SCORE.get(page.file, 80)
            fields[page.file] = report_fields(texts, score)
            if not fields_recovered(fields[page.file], page.truth["fields"], score):
                failures.append(f"{page.file}: fields {fields[page.file]} against "
                                f"{page.truth['fields']}")
    cer = character_error_rate([a for a, _ in pairs], [b for _, b in pairs])
    if cer > CER_BOUND:
        failures.append(f"CER against the record {cer:.4f} > {CER_BOUND}")
    return {
        "pages": len(runs),
        "boxes": sum(len(q) for _, q, _, _ in runs),
        "boxes_record": sum(len(p.jax["quads"]) for p, _, _, _ in runs),
        "tie_pages": tie_pages,
        "max_quad_px": max_gap,
        "lines_paired": len(pairs),
        "cer_vs_record": cer,
        "cer_truth": character_error_rate(truth_port, truth_texts),
        "cer_truth_record": character_error_rate(truth_record, truth_texts),
        "fields": fields,
        "failures": failures,
    }
