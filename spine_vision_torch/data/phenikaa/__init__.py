"""Phenikaa report preprocessing: OCR and the fuzzy field extraction.

Counterpart of ``spine_vision_tpu/data/phenikaa``: the OCR engine
(``ocr.py``) and the string half of the matching (``matching.py``). The
report processors and the patient/folder matching wait for ROADMAP Queue 1
item 11.
"""

# Vietnamese OCR field patterns (reference phenikaa/__init__.py:34-37).
NAME_FIELD_PATTERN = "Ho ten nguoi benh"
BIRTHDAY_FIELD_PATTERN = "Ngay sinh"
ID_FIELD_PATTERN = "So phieu"
