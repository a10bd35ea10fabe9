"""OCR helpers: the shipped weights' location and the character error rate.

Counterpart of the inference half of ``spine_vision_tpu/train/ocr.py``. The
OCR nets' trained weights ship with the JAX package
(``spine_vision_tpu/weights/ocr_{detector,recognizer}.npz``); they are read
as data, by path (``models/convert.py::load_variables_npz``), and every
loader takes a ``weights_dir``. Training and evaluating the OCR nets on the
card waits for the rest of ROADMAP Queue 1 item 10: their pages and lines
are rendered with PIL and TrueType fonts, which the card's host lacks.
"""

from __future__ import annotations

from pathlib import Path

DEFAULT_WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "spine_vision_tpu" / "weights"


def character_error_rate(predictions: list[str], targets: list[str]) -> float:
    """Summed Levenshtein distance over summed target length (each target
    counting at least 1): the standard CER."""
    total_dist = 0
    total_len = 0
    for pred, target in zip(predictions, targets):
        n = len(target)
        row = list(range(n + 1))
        for i in range(1, len(pred) + 1):
            prev = row[0]
            row[0] = i
            for j in range(1, n + 1):
                cur = row[j]
                row[j] = min(row[j] + 1, row[j - 1] + 1, prev + (pred[i - 1] != target[j - 1]))
                prev = cur
        total_dist += row[n]
        total_len += max(n, 1)
    return total_dist / max(total_len, 1)
