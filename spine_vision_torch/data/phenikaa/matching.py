"""Fuzzy field extraction from OCR lines: the string half of
``spine_vision_tpu/data/phenikaa/matching.py``.

The scores are rapidfuzz 3's, computed in pure Python so that the port
needs no native string-matching package:

- :func:`ratio`: the normalised Indel similarity x 100, ``(1 - (len1 + len2
  - 2 LCS) / (len1 + len2)) * 100``;
- :func:`partial_ratio`: the best :func:`ratio` of the shorter string
  against the longer string's windows, the partial windows at both ends
  included, taken in both directions when the lengths are equal.

Vietnamese diacritics fold with ``unicodedata`` (NFD, combining marks
dropped, đ/Đ -> d/D). Patients match image study folders
(``NAME(_YYYY)_YYYYMMDD( (N))``) by the folded name's partial ratio, the
birth year breaking ties (:class:`PatientMatcher`).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path

import numpy as np

from spine_vision_torch.core.logging import logger


def _lcs_length(block: dict[str, int], len1: int, s2: str) -> int:
    """Length of the longest common subsequence of ``s1`` (given as its
    character bit masks ``block``, ``len1`` long) and ``s2``: Hyyrö's
    bit-parallel recurrence on Python integers."""
    mask = (1 << len1) - 1
    s = mask
    for ch in s2:
        u = s & block.get(ch, 0)
        s = ((s + u) | (s - u)) & mask
    return len1 - bin(s).count("1")


def _block(s1: str) -> dict[str, int]:
    block: dict[str, int] = {}
    for i, ch in enumerate(s1):
        block[ch] = block.get(ch, 0) | (1 << i)
    return block


def _similarity(block: dict[str, int], s1: str, s2: str) -> float:
    """Normalised Indel similarity in [0, 1] (1 for two empty strings)."""
    lensum = len(s1) + len(s2)
    if lensum == 0:
        return 1.0
    dist = lensum - 2 * _lcs_length(block, len(s1), s2)
    return 1.0 - dist / lensum


def ratio(s1: str, s2: str) -> float:
    """rapidfuzz's ``fuzz.ratio``: the normalised Indel similarity x 100."""
    return _similarity(_block(s1), s1, s2) * 100


def _partial_ratio_impl(shorter: str, longer: str) -> float:
    """Best similarity of ``shorter`` against ``longer``'s windows: the
    prefixes shorter than ``shorter``, every full-length window, and the
    suffixes from the last full window on. A window whose newly entered end
    character is not in ``shorter`` is skipped: a neighbour scores at least
    as well."""
    chars = set(shorter)
    len1, len2 = len(shorter), len(longer)
    block = _block(shorter)
    best = 0.0
    windows = (
        [(0, i) for i in range(1, len1) if longer[i - 1] in chars]
        + [(i, i + len1) for i in range(len2 - len1) if longer[i + len1 - 1] in chars]
        + [(i, len2) for i in range(len2 - len1, len2) if longer[i] in chars]
    )
    for start, end in windows:
        best = max(best, _similarity(block, shorter, longer[start:end]))
        if best == 1.0:
            return 100.0
    return best * 100


def partial_ratio(s1: str, s2: str) -> float:
    """rapidfuzz's ``fuzz.partial_ratio``."""
    if not s1 and not s2:
        return 100.0
    shorter, longer = (s1, s2) if len(s1) <= len(s2) else (s2, s1)
    score = _partial_ratio_impl(shorter, longer)
    if score != 100 and len(s1) == len(s2):
        score = max(score, _partial_ratio_impl(longer, shorter))
    return score


def ascii_fold(text: str) -> str:
    """Transliterate to ASCII: strip combining marks, map đ/Đ -> d/D."""
    text = text.replace("đ", "d").replace("Đ", "D")
    decomposed = unicodedata.normalize("NFD", text)
    return "".join(c for c in decomposed if not unicodedata.combining(c))


def fuzzy_match_score(text1: str, text2: str, normalize: bool = True) -> float:
    """Partial-ratio score in [0, 100], optionally diacritic/case-folded."""
    if normalize:
        text1 = ascii_fold(text1).lower().strip()
        text2 = ascii_fold(text2).lower().strip()
    return partial_ratio(text1, text2)


def fuzzy_value_extract(
    text_lines: list[str],
    field: str,
    threshold: float = 80,
    window_length: int = 2,
) -> str | None:
    """The value after a fuzzy-matched field key in OCR lines, uppercased.

    A word window over each line splits it into (key ~ field, value) at the
    boundary where the key's ratio to the field is highest. Failing that, a
    character-level split of the line without spaces (CTC recognizers drop
    spaces: "Ngàysinh:15/05/1980"); that value is folded too.
    """
    field = field.lower()
    for line in text_lines:
        normalized = ascii_fold(line).lower().strip()
        if partial_ratio(field, normalized) <= threshold:
            continue

        key_word_count = len(field.split())
        words = normalized.split()
        if len(words) >= key_word_count:
            min_len = max(1, key_word_count - 1)
            max_len = min(len(words), key_word_count + window_length)
            best_score = 0.0
            best_end = 0
            for i in range(min_len, max_len + 1):
                candidate = " ".join(words[:i]).rstrip(" :.-")
                score = ratio(field, candidate.lower())
                if score > best_score:
                    best_score = score
                    best_end = i
            if best_score >= threshold:
                return "".join(words[best_end:]).lstrip(".:;").upper()

        compact = normalized.replace(" ", "")
        field_compact = field.replace(" ", "")
        lo = max(1, len(field_compact) - 4)
        hi = min(len(compact) - 1, len(field_compact) + 4)
        best_score, best_k = 0.0, 0
        for k in range(lo, hi + 1):
            score = ratio(field_compact, compact[:k].rstrip(" :.-"))
            if score > best_score:
                best_score, best_k = score, k
        if best_score >= threshold:
            value = compact[best_k:].lstrip(".:;").upper()
            if value:
                return value
    return None


def fuzzy_value_extract_spatial(
    lines: list[tuple[str, np.ndarray]],
    field: str,
    threshold: float = 80,
    window_length: int = 2,
) -> str | None:
    """Layout-aware field extraction over (text, quad) OCR lines.

    First the same-line split of :func:`fuzzy_value_extract`. Failing that,
    the line whose whole text matches the field as a bare label, and the
    nearest detected line beside it (to its right, overlapping vertically)
    or, if none, below it (overlapping horizontally), within a few label
    heights. Quads are the detector's ``[4, 2]`` (x, y) TL TR BR BL boxes.
    """
    texts = [t for t, _ in lines]
    value = fuzzy_value_extract(texts, field, threshold, window_length)
    if value:
        return value

    field_folded = field.lower()
    boxes = []
    for text, quad in lines:
        q = np.asarray(quad, dtype=np.float64).reshape(4, 2)
        boxes.append((text, q[:, 0].min(), q[:, 0].max(), q[:, 1].min(), q[:, 1].max()))

    best_key = None
    best_score = 0.0
    for i, (text, *_rect) in enumerate(boxes):
        folded = ascii_fold(text).lower().strip().rstrip(" :.-")
        if not folded:
            continue
        score = ratio(field_folded, folded)
        if score >= threshold and score > best_score:
            best_score = score
            best_key = i
    if best_key is None:
        return None

    _, kx1, kx2, ky1, ky2 = boxes[best_key]
    key_h = max(ky2 - ky1, 1.0)
    # A value in the key's own row (a right-hand column) beats one below it;
    # the distance caps keep a missed value from pairing with a far line.
    beside: list[tuple[float, str]] = []
    below: list[tuple[float, str]] = []
    for j, (text, x1, x2, y1, y2) in enumerate(boxes):
        if j == best_key or not text.strip():
            continue
        yc = (y1 + y2) / 2.0
        if (
            x1 >= kx2 - key_h
            and x1 - kx2 <= 10.0 * key_h
            and ky1 - key_h / 2 <= yc <= ky2 + key_h / 2
        ):
            beside.append((x1 - kx2, text))
        elif (
            ky2 - key_h / 2 <= y1 <= ky2 + 3.0 * key_h
            and min(x2, kx2) - max(x1, kx1) > 0
        ):
            below.append(((y1 - ky2) + abs(x1 - kx1) * 0.1, text))
    candidates = beside or below
    if not candidates:
        return None
    best_value = min(candidates)[1]
    folded_value = ascii_fold(best_value).replace(" ", "")
    return folded_value.lstrip(".:;").upper() or None


def fuzzy_find_best_match(
    query: str,
    candidates: list[str],
    threshold: float = 80,
    normalize: bool = True,
) -> tuple[str | None, float]:
    """Best-scoring candidate above threshold, with its score."""
    best_match = None
    best_score = 0.0
    for candidate in candidates:
        score = fuzzy_match_score(query, candidate, normalize)
        if score > best_score:
            best_score = score
            best_match = candidate
    if best_score >= threshold:
        return best_match, best_score
    return None, best_score


# Patient image folder names: NAME(_YYYY)?_YYYYMMDD( (N))?
IMAGE_FOLDER_REGEX = re.compile(r"^[A-Z_]+(_\d{4})?_\d{8}( \(\d+\))?$")


@dataclass
class FolderInfo:
    """A parsed patient image folder."""

    path: Path
    name_part: str
    birth_year: str | None


def parse_image_folder_name(folder_name: str) -> tuple[str, str | None]:
    """Split ``PATIENT_NAME(_YYYY)_YYYYMMDD( (N))`` into (name, birth year)."""
    base_name = re.sub(r" \(\d+\)$", "", folder_name)
    parts = base_name.split("_")
    if len(parts) >= 3 and re.fullmatch(r"\d{4}", parts[-2]):
        return "".join(parts[:-2]), parts[-2]
    return "".join(parts[:-1]), None


def build_folder_lookup(image_path: Path) -> dict[str, FolderInfo]:
    """Index the patient folders under ``image_path``, recursively, keyed
    by the folder's path: two studies of one patient, or two patients of one
    name, both stay visible."""
    folder_dict: dict[str, FolderInfo] = {}
    for path in Path(image_path).rglob("*"):
        if not path.is_dir() or not IMAGE_FOLDER_REGEX.match(path.name):
            continue
        name_part, birth_year = parse_image_folder_name(path.name)
        folder_dict[str(path)] = FolderInfo(path=path, name_part=name_part, birth_year=birth_year)
    return folder_dict


def find_matching_folder(
    patient_name: str,
    patient_birthday: str,
    folder_map: dict[str, FolderInfo],
    threshold: float = 85,
    date_format: str = "%d/%m/%Y",
) -> Path | None:
    """The folder whose name scores best above ``threshold`` (both sides
    folded), ties broken by the birth year, then by a folder without one."""
    try:
        patient_birth_year: int | None = datetime.strptime(patient_birthday, date_format).year
    except ValueError:
        logger.warning("Could not parse birthday: %s", patient_birthday)
        patient_birth_year = None

    candidates = []
    for info in folder_map.values():
        score = fuzzy_match_score(patient_name, info.name_part)
        if score > threshold:
            candidates.append((score, info))
    if not candidates:
        return None

    candidates.sort(key=lambda c: c[0], reverse=True)
    best_score = candidates[0][0]
    top = [info for score, info in candidates if score == best_score]

    if patient_birth_year is not None:
        for info in top:
            if info.birth_year == str(patient_birth_year):
                return info.path
    for info in top:
        if info.birth_year is None:
            return info.path
    return top[0].path


def find_matching_folder_by_name(
    patient_name: str,
    folder_map: dict[str, FolderInfo],
    threshold: float = 85,
) -> Path | None:
    """Name-only variant (when no birthday is available)."""
    best: tuple[float, FolderInfo] | None = None
    for info in folder_map.values():
        score = fuzzy_match_score(patient_name, info.name_part)
        if score > threshold and (best is None or score > best[0]):
            best = (score, info)
    return best[1].path if best else None


class PatientMatcher:
    """Folder matcher over one image tree's lookup."""

    def __init__(
        self,
        image_path: Path,
        threshold: float = 85,
        date_format: str = "%d/%m/%Y",
    ) -> None:
        self.threshold = threshold
        self.date_format = date_format
        self.folder_map = build_folder_lookup(image_path)
        logger.info("Built folder lookup with %d entries", len(self.folder_map))

    def match(self, patient_name: str, patient_birthday: str) -> Path | None:
        return find_matching_folder(
            patient_name, patient_birthday, self.folder_map, self.threshold, self.date_format
        )

    def match_by_name(self, patient_name: str) -> Path | None:
        return find_matching_folder_by_name(patient_name, self.folder_map, self.threshold)
