"""The port's pure-Python fuzzy scores and field extraction
(``spine_vision_torch/data/phenikaa/matching.py``) against rapidfuzz 3 and
``spine_vision_tpu/data/phenikaa/matching.py``: every score and every
extracted value equal, no tolerance.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from rapidfuzz import fuzz

from spine_vision_torch.data.phenikaa import (
    BIRTHDAY_FIELD_PATTERN,
    ID_FIELD_PATTERN,
    NAME_FIELD_PATTERN,
)
from spine_vision_torch.data.phenikaa import matching as tm
from spine_vision_tpu.data.phenikaa import matching as jm

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"
# A small alphabet makes common subsequences (and ties) likely.
ALPHABET = "aăâbdđeêhiknoôơuưy ĐẠỆỞ:/015"
TEXT = st.text(alphabet=ALPHABET, max_size=24)
FIELDS = (NAME_FIELD_PATTERN, BIRTHDAY_FIELD_PATTERN, ID_FIELD_PATTERN)


@settings(max_examples=300, deadline=None)
@given(TEXT, TEXT)
def test_scores_equal_rapidfuzz(s1, s2):
    assert tm.ratio(s1, s2) == fuzz.ratio(s1, s2)
    assert tm.partial_ratio(s1, s2) == fuzz.partial_ratio(s1, s2)


@settings(max_examples=150, deadline=None)
@given(st.integers(0, 12).flatmap(lambda n: st.tuples(
    st.text(alphabet=ALPHABET, min_size=n, max_size=n),
    st.text(alphabet=ALPHABET, min_size=n, max_size=n))))
def test_partial_ratio_of_equal_lengths_equals_rapidfuzz(pair):
    s1, s2 = pair
    assert tm.partial_ratio(s1, s2) == fuzz.partial_ratio(s1, s2)


@pytest.mark.parametrize("s1,s2", [
    ("", ""), ("", "abc"), ("abc", ""), ("a", "ba"), ("ab", "xaby"), ("đ", "Đđ"),
    ("ngay sinh", "ngaysinh:15/05/1980"), ("so phieu", "so phieu: 250012345"),
    ("Nguyễn Văn An", "NGUYEN VAN AN"), ("x" * 70, "xy" * 50),
])
def test_scores_equal_rapidfuzz_on_edge_cases(s1, s2):
    assert tm.ratio(s1, s2) == fuzz.ratio(s1, s2)
    assert tm.partial_ratio(s1, s2) == fuzz.partial_ratio(s1, s2)


def _record_lines():
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    return {p["file"]: list(zip(p["jax"]["texts"], np.asarray(p["jax"]["quads"])))
            for p in manifest["pages"]}


def test_field_extraction_equals_jax_on_the_record():
    """On every page of the OCR record, each field pattern at the JAX
    tests' thresholds and windows gives the JAX package's value, same-line
    and spatial; and the report pages give their fields."""
    for file, lines in _record_lines().items():
        texts = [t for t, _ in lines]
        for field in FIELDS:
            for threshold, window in ((80, 3), (75, 2)):
                assert (tm.fuzzy_value_extract(texts, field, threshold, window)
                        == jm.fuzzy_value_extract(texts, field, threshold, window)), (file, field)
                assert (tm.fuzzy_value_extract_spatial(lines, field, threshold, window)
                        == jm.fuzzy_value_extract_spatial(lines, field, threshold, window))
    clean = [t for t, _ in _record_lines()["report_clean.png"]]
    assert tm.fuzzy_value_extract(clean, ID_FIELD_PATTERN, 80) == "250012345"


def test_spatial_extraction_pairs_a_label_with_the_box_below():
    lines = [("Số phiếu", np.array([[10, 10], [90, 10], [90, 30], [10, 30]], float)),
             ("250 012 345", np.array([[12, 40], [120, 40], [120, 60], [12, 60]], float)),
             ("Chẩn đoán", np.array([[10, 200], [90, 200], [90, 220], [10, 220]], float))]
    want = jm.fuzzy_value_extract_spatial(lines, ID_FIELD_PATTERN)
    assert tm.fuzzy_value_extract_spatial(lines, ID_FIELD_PATTERN) == want == "250012345"


def test_best_match_and_folding_equal_jax():
    candidates = ["NGUYEN_VAN_AN_19800515", "TRAN THI HUONG", "Lê Đức Phúc", ""]
    for query in ("Nguyễn Văn An", "Trần Thị Hương", "le duc phuc", "xyz"):
        for normalize in (True, False):
            assert (tm.fuzzy_find_best_match(query, candidates, 80, normalize)
                    == jm.fuzzy_find_best_match(query, candidates, 80, normalize))
    assert tm.ascii_fold("Đặng Văn Long Uyên") == jm.ascii_fold("Đặng Văn Long Uyên")
