"""The port's label-table loading and record CSV writing
(``spine_vision_torch/io/tabular.py``, the ``csv`` module) against the JAX
package's (pandas): the counterparts of ``tests/test_tabular.py``.

``load_tabular_data`` returns the JAX DataFrame's ``to_dict("records")``
exactly: the same rows in the same order, the same columns in the same
order, each value of the same Python type (int, float, bool, str) and
value.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass

import pandas as pd
import pytest

from spine_vision_torch.io.tabular import load_tabular_data, write_records_csv
from spine_vision_tpu.io.tabular import load_tabular_data as jax_load


def _typed(rows):
    return [[(k, "NaN" if isinstance(v, float) and math.isnan(v) else (type(v).__name__, v))
             for k, v in r.items()] for r in rows]


def _assert_same(path, **kw):
    got = load_tabular_data(path, **kw)
    want = jax_load(path, **kw).to_dict("records")
    assert _typed(got) == _typed(want)
    return got


def test_load_tabular_concat_dedup_dropna_filter_onehot(tmp_path):
    a = pd.DataFrame({"Patient ID": [1, 2, 3, 3], "Modic": ["0", "1&2", "2", "2"],
                      "Grade": [1.0, 2.0, 3.0, 3.0]})
    b = pd.DataFrame({"Patient ID": [4, 5], "Modic": ["1.0", None], "Grade": [2.0, 1.0]})
    a.to_csv(tmp_path / "a.csv", index=False)
    (tmp_path / "sub").mkdir()
    b.to_csv(tmp_path / "sub" / "b.csv", index=False)
    rows = _assert_same(tmp_path, corrupted_ids=[4], one_hot_col="Modic", one_hot_sep="&")
    assert sorted(r["Patient ID"] for r in rows) == [1, 2, 3]
    row2 = next(r for r in rows if r["Patient ID"] == 2)
    assert row2["Modic_1"] == 1 and row2["Modic_2"] == 1 and "Modic" not in row2


TABLES = {
    "a.csv": "Patient ID,Modic,Grade,flag,s\n1,0,1.0,True,a\n2,1&2,2.0,False,b\n"
             "3,2,3.0,True,c\n3,2,3.0,True,c\n",
    "sub/b.csv": "Patient ID,Modic,Grade,flag,s\n4,1.0,2,True,d\n5,,1,False,e\n6,3,2.5,False,f\n",
    "c.csv": "Patient ID,Modic,Grade,flag,s\n7,2.0,abc,1,g\n8,1&3,4,0,h\n9,1.5,1e3,True,\"q,r\"\n"
             "\n10,NA,5,True,i\n",
    "d.csv": "Patient ID,Modic,Grade,extra,extra\n11,1,2,x,y\n12,N/A,3,z,w\n",
}


@pytest.mark.parametrize("kw", [
    {}, {"corrupted_ids": [4, 8], "one_hot_col": "Modic"}, {"one_hot_col": "Grade"},
    {"exclude_files": ["c.csv", "d.csv"], "one_hot_col": "Modic", "corrupted_ids": [2]},
    {"exclude_files": ["d.csv"], "id_col": "s", "corrupted_ids": ["a", "q,r"]},
    {"exclude_files": ["a.csv", "b.csv", "c.csv"], "one_hot_col": "extra.1"},
], ids=["plain", "ids_onehot", "float_onehot", "exclude", "str_ids", "duplicate_names"])
def test_typed_columns_match_pandas(tmp_path, kw):
    """Columns widened across files (int with float, numbers with text),
    bools, quoted fields, blank lines, NA strings, duplicate names."""
    for name, text in TABLES.items():
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_text(text)
    _assert_same(tmp_path, **kw)


def test_load_tabular_excludes_files_and_warns_on_unknown(tmp_path, caplog):
    pd.DataFrame({"Patient ID": [1], "x": [1]}).to_csv(tmp_path / "keep.csv", index=False)
    pd.DataFrame({"Patient ID": [9], "x": [9]}).to_csv(tmp_path / "skip.csv", index=False)
    (tmp_path / "notes.txt").write_text("not a table")
    with caplog.at_level(logging.WARNING, logger="spine_vision_torch"):
        rows = _assert_same(tmp_path, exclude_files=["skip.csv"])
    assert [r["Patient ID"] for r in rows] == [1]
    assert "notes.txt" in caplog.text
    # An Excel table is skipped with a warning: the port reads no Excel.
    (tmp_path / "labels.xlsx").write_bytes(b"PK\x03\x04 not read")
    with caplog.at_level(logging.WARNING, logger="spine_vision_torch"):
        assert load_tabular_data(tmp_path, exclude_files=["skip.csv"]) == rows
    assert "labels.xlsx" in caplog.text and "Excel" in caplog.text


def test_load_tabular_empty_dir_returns_empty(tmp_path):
    assert load_tabular_data(tmp_path) == []
    assert jax_load(tmp_path).empty


@dataclass
class _Rec:
    image_path: str
    grade: int


class _Model:
    def model_dump(self):
        return {"image_path": "c.png", "grade": 2}


def test_write_records_csv_dataclass_and_dict(tmp_path):
    path = tmp_path / "out" / "out.csv"
    write_records_csv([_Rec("a.png", 3), {"image_path": "b.png", "grade": 1}, _Model()], path)
    back = pd.read_csv(path)
    assert back["image_path"].tolist() == ["a.png", "b.png", "c.png"]
    assert back["grade"].tolist() == [3, 1, 2]
    assert load_tabular_data(path.parent) == back.to_dict("records")
    with pytest.raises(TypeError, match="Unsupported record type"):
        write_records_csv([object()], tmp_path / "bad.csv")


def test_write_records_csv_rejects_empty(tmp_path):
    with pytest.raises(ValueError, match="empty"):
        write_records_csv([], tmp_path / "x.csv")
