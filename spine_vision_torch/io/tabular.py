"""Tabular I/O: record CSV writing and label-table loading, without pandas.

Counterpart of ``spine_vision_tpu/io/tabular.py``, whose
``load_tabular_data`` returns a pandas DataFrame; pandas is not on the
card's machine, so here it returns the frame's rows as dicts
(``df.to_dict("records")``: the columns in the frame's order, native Python
values) read with the ``csv`` module. Each column is typed as
``pd.read_csv`` types it: bool, int, float where a value is fractional or
missing (NaN), otherwise str; the concatenation of several files widens a
column as ``pd.concat`` does (int with float to float, anything else mixed
to object, values kept). Then the same steps: ``drop_duplicates`` (NaN
equal to NaN), ``dropna``, the corrupted-ID filter, and the one-hot
expansion of a separator-joined column after stripping ``.0`` (its
indicator columns sorted, appended, the column dropped). Excel files are
skipped with a warning: reading them needs openpyxl, which the port does not
import (the JAX package warns and skips them too where no Excel engine is
installed).
"""

from __future__ import annotations

import csv
import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Sequence

from spine_vision_torch.core.logging import logger

EXCEL_FORMATS = {".xlsx", ".xls", ".xlsm"}

# pd.read_csv's default missing-value strings.
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
          "false": False}
_INT = re.compile(r"\s*[+-]?\d+\s*")
_NAN = float("nan")


def _is_na(value: Any) -> bool:
    return isinstance(value, float) and math.isnan(value)


def _record_to_dict(record: Any) -> dict[str, Any]:
    if isinstance(record, dict):
        return record
    if dataclasses.is_dataclass(record) and not isinstance(record, type):
        return dataclasses.asdict(record)
    if hasattr(record, "model_dump"):  # pydantic v2
        return record.model_dump()
    raise TypeError(f"Unsupported record type: {type(record)}")


def write_records_csv(records: Sequence[Any], csv_path: Path) -> None:
    """Write records (pydantic-like / dataclass / dict) to a CSV file.

    Raises:
        ValueError: If the records list is empty.
    """
    if not records:
        raise ValueError("Cannot write empty records list")
    rows = [_record_to_dict(r) for r in records]
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    logger.info("Wrote %d records to %s", len(rows), csv_path)


def write_table_csv(rows: Sequence[dict[str, Any]], csv_path: Path, columns: Sequence[str]) -> None:
    """Write a table of row dicts as ``DataFrame.to_csv(path, index=False)``
    writes a frame of those columns: the header, then each row, fields
    quoted only where needed, lines ending in ``\n``. Values are written as
    ``str`` gives them (the frame's ints and strings; pandas writes floats
    by ``repr`` too). No rows give the header alone."""
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([[row[c] for c in columns] for row in rows])


def _float(text: str) -> float | None:
    if "_" in text:
        return None
    try:
        return float(text)
    except ValueError:
        return None


def _typed_column(raw: list[str]) -> tuple[str, list[Any]]:
    """(kind, values) of one CSV column: kind in bool, int, float, object."""
    present = [v for v in raw if v not in _NA]
    missing = len(present) < len(raw)
    if not present:
        return "float", [_NAN] * len(raw)
    if all(v in _BOOLS for v in present):
        kind, parse = ("object" if missing else "bool"), _BOOLS.__getitem__
    elif all(_INT.fullmatch(v) for v in present):
        kind, parse = ("float", lambda v: float(int(v))) if missing else ("int", int)
    elif all(_float(v) is not None for v in present):
        kind, parse = "float", _float
    else:
        kind, parse = "object", str
    return kind, [_NAN if v in _NA else parse(v) for v in raw]


def _read_csv(path: Path) -> tuple[list[str], dict[str, tuple[str, list[Any]]], int]:
    """Column names (duplicates renamed ``name.1``, ...), typed columns and
    the row count."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"No columns to parse from file {path}")
    header, body = rows[0], rows[1:]
    names: list[str] = []
    for name in header:
        base, k = name, 0
        while name in names:
            k += 1
            name = f"{base}.{k}"
        names.append(name)
    columns = {
        name: _typed_column([r[i] if i < len(r) else "" for r in body])
        for i, name in enumerate(names)
    }
    return names, columns, len(body)


def _concat(frames: list[tuple[list[str], dict[str, tuple[str, list[Any]]], int]]) -> tuple:
    """Outer concatenation: columns in order of appearance, widened."""
    order: list[str] = []
    for names, _, _ in frames:
        order += [n for n in names if n not in order]
    columns = {}
    for name in order:
        kinds, values = set(), []
        for _, cols, n_rows in frames:
            kind, vals = cols.get(name, ("missing", [_NAN] * n_rows))
            kinds.add(kind)
            values += vals
        if kinds != {"int"} and kinds <= {"int", "float", "missing"}:
            values = [float(v) for v in values]
        columns[name] = values
    return order, columns


def load_tabular_data(
    table_path: Path,
    exclude_files: list[str] | None = None,
    id_col: str = "Patient ID",
    corrupted_ids: list[int] | None = None,
    one_hot_col: str | None = None,
    one_hot_sep: str = "&",
) -> list[dict[str, Any]]:
    """Recursively load the CSV label tables under ``table_path`` into one
    cleaned table, as a list of row dicts.

    Concatenates every ``.csv`` file (sorted paths), drops duplicate rows
    and rows with a missing value, filters corrupted patient IDs, and
    optionally expands a separator-joined column into one-hot indicator
    columns (``"1&2"`` gives ``Modic_1 = Modic_2 = 1``).
    """
    exclude_files = exclude_files or []
    corrupted_ids = corrupted_ids or []

    frames = []
    for file_path in sorted(Path(table_path).rglob("*")):
        if not file_path.is_file() or file_path.name in exclude_files:
            continue
        suffix = file_path.suffix.lower()
        if suffix == ".csv":
            frames.append(_read_csv(file_path))
        elif suffix in EXCEL_FORMATS:
            logger.warning(
                "Skipping %s (no Excel engine: the port reads CSV tables only)", file_path
            )
        else:
            logger.warning("Unsupported format: %s", file_path)

    if not frames:
        logger.warning("No valid data files found in %s", table_path)
        return []

    order, columns = _concat(frames)
    rows = [dict(zip(order, vals)) for vals in zip(*(columns[n] for n in order))]
    before = len(rows)
    seen: set[tuple] = set()
    unique = []
    for row in rows:
        key = tuple(("NaN",) if _is_na(v) else v for v in row.values())
        if key not in seen:
            seen.add(key)
            unique.append(row)
    rows = unique
    logger.debug("Dropped %d duplicate rows", before - len(rows))
    before = len(rows)
    rows = [r for r in rows if not any(_is_na(v) for v in r.values())]
    logger.debug("Dropped %d rows with NA", before - len(rows))

    if corrupted_ids and id_col in order:
        bad = set(corrupted_ids)
        rows = [r for r in rows if r[id_col] not in bad]

    if one_hot_col and one_hot_col in order:
        tokens = [
            re.sub(r"\.0\b", "", str(r[one_hot_col])).split(one_hot_sep) for r in rows
        ]
        tags = sorted({t for ts in tokens for t in ts} - {""})
        for row, ts in zip(rows, tokens):
            del row[one_hot_col]
            row.update({f"{one_hot_col}_{t}": int(t in ts) for t in tags})

    logger.info("Loaded %d rows from tabular data", len(rows))
    return rows
