"""The port's Phenikaa report preprocessing against the JAX package's.

The folder lookup, ``find_matching_folder*`` and ``PatientMatcher`` on the
JAX tests' folder trees (``tests/test_phenikaa.py``) and more, every answer
equal; the registry and ``preprocess_phenikaa`` with the JAX test's fake
extractor through both packages, the output table and the copied trees equal
byte for byte; then the shipped OCR weights on a fixture report page (the
port alone, on the CPU) and the refusal of an Orbax checkpoint.
"""

import csv
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from spine_vision_torch.data import phenikaa as tp
from spine_vision_torch.data.phenikaa import matching as tm
from spine_vision_torch.data.phenikaa.ocr import DocumentExtractor
from spine_vision_tpu.data import phenikaa as jp
from spine_vision_tpu.data.phenikaa import matching as jm
from spine_vision_tpu.data.phenikaa.ocr import DocumentExtractor as JaxDocumentExtractor

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_ocr"

FOLDER_NAMES = ("NGUYEN_VAN_A_1980_20240101", "TRAN_THI_B_20240202", "LE_VAN_C_1975_20240303 (2)",
                "NGUYEN_VAN_A", "nguyen_van_a_20240101", "BUI_THI_DUNG_1985_20240101",
                "A_B_C_D_1999_20240101", "X_20240101", "_1980_20240101")

# Folder trees (relative paths) and the (name, birthday) queries held to JAX.
TREES = {
    "birth_year_tiebreak": (("NGUYEN_VAN_A_1980_20240101", "NGUYEN_VAN_A_1990_20240102"),
                            [("NGUYENVANA", "01/01/1990"), ("NGUYENVANA", "01/01/1980"),
                             ("NGUYENVANA", "01/01/2000"), ("NGUYENVANA", "not a date")]),
    "colliding_names": (("TRAN_THI_B_20240101", "TRAN_THI_B_20240601", "siteA/LE_VAN_C_20240201",
                         "siteB/LE_VAN_C_20240201"),
                        [("TRANTHIB", "01/01/1990"), ("LEVANC", "02/02/1975")]),
    "diacritics": (("BUI_THI_DUNG_1985_20240101", "BUI_THI_DUNG_20240301"),
                   [("BùiThịDung", "02/03/1985"), ("BùiThịDung", "02/03/1999"),
                    ("Bui Thi Dung", "02/03/1985"), ("Đặng Văn Em", "01/01/1970")]),
    "decoys": (("NGUYEN_VAN_AN_1980_20240101", "NGUYEN_VAN_ANH_1980_20240101",
                "NGUYEN_VAN_AN_1990_20240105", "TRAN_THI_HUONG_1975_20240103", "notes",
                "NGUYEN_VAN_AN_1980_20240101/SAG_T1_20240101"),
               [("NguyễnVănAn", "15/05/1980"), ("NGUYENVANAN", "15/05/1990"),
                ("TrầnThịHương", "02/11/1975"), ("Nobody", "01/01/2000")]),
}


@pytest.mark.parametrize("name", FOLDER_NAMES)
def test_parse_image_folder_name_matches_jax(name):
    assert tm.parse_image_folder_name(name) == jm.parse_image_folder_name(name)
    assert bool(tm.IMAGE_FOLDER_REGEX.match(name)) == bool(jm.IMAGE_FOLDER_REGEX.match(name))


def test_parse_image_folder_name():
    assert tm.parse_image_folder_name("NGUYEN_VAN_A_1980_20240101") == ("NGUYENVANA", "1980")
    assert tm.parse_image_folder_name("TRAN_THI_B_20240202") == ("TRANTHIB", None)
    assert tm.parse_image_folder_name("LE_VAN_C_1975_20240303 (2)") == ("LEVANC", "1975")


def _make_tree(root, folders):
    for rel in folders:
        (root / rel).mkdir(parents=True, exist_ok=True)
    return root


@pytest.mark.parametrize("tree", sorted(TREES))
def test_matching_matches_jax(tmp_path, tree):
    folders, queries = TREES[tree]
    root = _make_tree(tmp_path, folders)
    got, want = tm.build_folder_lookup(root), jm.build_folder_lookup(root)
    assert list(got) == list(want)
    assert [vars(v) for v in got.values()] == [vars(v) for v in want.values()]
    port, ref = tm.PatientMatcher(root), jm.PatientMatcher(root)
    for name, birthday in queries:
        for threshold in (85, 60):
            assert (tm.find_matching_folder(name, birthday, got, threshold)
                    == jm.find_matching_folder(name, birthday, want, threshold)), (name, threshold)
            assert (tm.find_matching_folder_by_name(name, got, threshold)
                    == jm.find_matching_folder_by_name(name, want, threshold)), (name, threshold)
        assert port.match(name, birthday) == ref.match(name, birthday)
        assert port.match_by_name(name) == ref.match_by_name(name)


def test_matching_answers(tmp_path):
    """The JAX tests' answers: the birth year breaks a tie, colliding names
    all stay indexed, folding matches diacritics."""
    root = _make_tree(tmp_path / "a", TREES["birth_year_tiebreak"][0])
    match = tm.find_matching_folder("NGUYENVANA", "01/01/1990", tm.build_folder_lookup(root))
    assert match is not None and match.name == "NGUYEN_VAN_A_1990_20240102"
    root = _make_tree(tmp_path / "b", TREES["colliding_names"][0])
    assert len(tm.build_folder_lookup(root)) == 4
    root = _make_tree(tmp_path / "c", TREES["diacritics"][0])
    match = tm.PatientMatcher(root).match("BùiThịDung", "02/03/1985")
    assert match is not None and match.name == "BUI_THI_DUNG_1985_20240101"


def _fake_extractor(base):
    """The JAX test's fake: canned lines per report stem, stacked 40 px apart."""

    class Fake(base):
        def __init__(self, per_report):  # no nets
            self.per_report = per_report

        def extract(self, path):
            return self.per_report.get(Path(path).stem, [])

        def extract_lines(self, path):
            return [(text, np.array([[10, 40 * i], [400, 40 * i], [400, 40 * i + 30],
                                     [10, 40 * i + 30]], dtype=np.float32))
                    for i, text in enumerate(self.extract(path))]

        def extract_from_pdf_crop(self, path, crop_region, dpi=200):
            return []

    return Fake


CANNED = {
    "250012345": ["Ho ten nguoi benh: Nguyen Van A", "Ngay sinh: 15/05/1980"],
    "250099999": ["Ho ten nguoi benh: Tran Thi B", "Ngay sinh: 01/01/1990"],  # not labelled
    "Le_Van_C_19750303": ["Phieu chi dinh", "So phieu: 250077777 Ngay 03/03/2024",
                          "Ngay sinh: 03/03/1975"],
    "Pham Van D": ["So phieu:", "250066666", "Ngay sinh:", "04/04/1960"],  # no folder
    "scan 01-02": ["So phieu: 250012345"],  # no processor
    "Hoang_Thi_E": ["So phieu: 250055555"],  # no birthday: matched by name
}


def _phenikaa_tree(root):
    data = root / "raw"
    images, tables = data / "images", data / "labels" / "tables"
    reports = data / "labels" / "reports"
    for d in (images, tables, reports):
        d.mkdir(parents=True)
    for folder, files in (("NGUYEN_VAN_A_1980_20240101", ("dummy.txt", "SAG T1/slice_0001.dcm")),
                          ("NGUYEN_VAN_A_1990_20240101", ("decoy.txt",)),
                          ("TRAN_THI_B_1990_20240105", ()),
                          ("LE_VAN_C_1975_20240303", ("scan.dcm",)),
                          ("HOANG_THI_E_20240505", ("e.dcm",))):
        (images / folder).mkdir()
        for name in files:
            (images / folder / name).parent.mkdir(parents=True, exist_ok=True)
            (images / folder / name).write_text(f"{folder}/{name}")
    rows = [
        {"Patient ID": 250012345, "IVD label": 1, "Pfirrman grade": 2, "Modic": 0},
        {"Patient ID": 250012345, "IVD label": 2, "Pfirrman grade": 3, "Modic": "1&2"},
        {"Patient ID": 250077777, "IVD label": 1, "Pfirrman grade": 4, "Modic": 3},
        {"Patient ID": 250066666, "IVD label": 1, "Pfirrman grade": 1, "Modic": 0},
        {"Patient ID": 250055555, "IVD label": 5, "Pfirrman grade": 5, "Modic": 2.0},
        {"Patient ID": 250055555, "IVD label": 5, "Pfirrman grade": 5, "Modic": 2.0},  # repeat
        {"Patient ID": 999999999, "IVD label": 1, "Pfirrman grade": 1, "Modic": 0},
        {"Patient ID": 25001, "IVD label": 1, "Pfirrman grade": 1, "Modic": 0},  # corrupted
    ]
    with open(tables / "labels.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for stem in CANNED:
        Image.fromarray(np.zeros((32, 64), dtype=np.uint8)).save(reports / f"{stem}.png")
    (reports / "notes.txt").write_text("not a report")
    return data


def test_preprocess_phenikaa_matches_jax(tmp_path):
    """The fake extractor through both packages: the same reports matched,
    the same folders copied, the table byte for byte."""
    out = {}
    for name, pkg, base in (("port", tp, DocumentExtractor), ("jax", jp, JaxDocumentExtractor)):
        data = _phenikaa_tree(tmp_path / name)
        config = pkg.PreprocessConfig(data_path=data, output_path=tmp_path / name / "interim")
        result = pkg.preprocess_phenikaa(config, extractor=_fake_extractor(base)(CANNED))
        out[name] = (config.output_path, result)
    (port_out, result), (jax_out, jresult) = out["port"], out["jax"]
    assert result == type(result)(num_samples=3, output_path=port_out,
                                  summary="Matched 3 of 5 patients")
    assert (jresult.num_samples, jresult.summary) == (result.num_samples, result.summary)

    def files(root):
        return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}

    got, want = files(port_out), files(jax_out)
    assert got == want
    assert sorted({p.parts[1] for p in got if p.parts[0] == "images"}) == [
        "250012345", "250055555", "250077777"]
    table = got[Path("radiological_labels.csv")].decode()
    assert table.splitlines()[0] == (
        "Patient ID,IVD label,Pfirrman grade,Modic_0,Modic_1,Modic_2,Modic_3")


def test_registry_dispatch_matches_jax(tmp_path):
    names = ("250012345.png", "NGUYEN_VAN_SON_20250718.pdf", "scan 01-02.tiff",
             "Nguyễn Văn An 15051980.png", "Tran_Thi_B.jpg", "12ab.png")
    port, ref = tp.build_report_processor_registry(), jp.build_report_processor_registry()
    for name in names:
        path = tmp_path / name
        path.touch()
        assert ([p.can_process(path) for p in port._processors]
                == [p.can_process(path) for p in ref._processors]), name
    assert port._processors[0].can_process(tmp_path / "250012345.png")
    assert port._processors[1].can_process(tmp_path / "NGUYEN_VAN_SON_20250718.pdf")
    assert not port._processors[1].can_process(tmp_path / "scan 01-02.tiff")
    for stem in ("NGUYEN_VAN_SON_20250718", "Nguyen Van A 19800515", "NGUYEN_VAN_SON"):
        assert (tp.PatientNamedReportProcessor._parse_filename(stem)
                == jp.PatientNamedReportProcessor._parse_filename(stem))
    for text in ("So phieu: 250099999 Ngay 15/05/2024", "250012345", "2500 99999", "15/05/2024",
                 "no digits here"):
        assert tp._id_from_text(text) == jp._id_from_text(text)


def test_collect_report_files_matches_jax(tmp_path):
    for name in ("a.pdf", "b.PDF", "c.JPG", "d.txt", "sub/e.png", "f.jpeg"):
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_bytes(b"x")
    assert tp.collect_report_files(tmp_path) == jp.collect_report_files(tmp_path)
    assert {p.name for p in tp.collect_report_files(tmp_path)} == {
        "a.pdf", "b.PDF", "c.JPG", "e.png", "f.jpeg"}


def test_shipped_ocr_reads_a_patient_named_report(tmp_path):
    """``preprocess_phenikaa`` with the shipped OCR weights (on the CPU) on
    ``report_clean.png`` under the record's patient name: the ID, name and
    birthday equal the record's, the folder with the record's birth year is
    copied and the table keeps that ID alone."""
    import json

    record = next(p for p in json.loads((FIXTURES / "manifest.json").read_text())["pages"]
                  if p["file"] == "report_clean.png")["truth"]["fields"]
    data = tmp_path / "raw"
    reports, tables = data / "labels" / "reports", data / "labels" / "tables"
    reports.mkdir(parents=True)
    tables.mkdir(parents=True)
    day, month, year = record["birthday"].split("/")
    stem = "_".join(record["name"].split()) + f"_{day}{month}{year}"
    shutil.copy(FIXTURES / "report_clean.png", reports / f"{stem}.png")
    _make_tree(data / "images", [f"NGUYEN_VAN_AN_{year}_20240101/SAG T1",
                                 "NGUYEN_VAN_AN_1990_20240102", "NGUYEN_VAN_ANH_1980_20240101"])
    (tables / "labels.csv").write_text(
        f"Patient ID,IVD label,Modic\n{record['id']},1,0\n{record['id']},2,1\n250000001,1,0\n")
    extractor = DocumentExtractor(device="cpu")
    info = tp.build_report_processor_registry().process(reports / f"{stem}.png", extractor, 80)
    assert info.patient_id == int(record["id"])
    assert info.patient_name == record["name"].replace(" ", "")
    assert info.patient_birthday == record["birthday"]

    config = tp.PreprocessConfig(data_path=data, output_path=tmp_path / "interim")
    result = tp.preprocess_phenikaa(config, extractor=extractor)
    assert result.num_samples == 1
    assert (config.output_image_path / record["id"] / "SAG T1").is_dir()
    assert config.output_table_path.read_text() == (
        f"Patient ID,IVD label,Modic_0,Modic_1\n{record['id']},1,1,0\n{record['id']},2,0,1\n")


PDF_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_pdf"


def test_shipped_ocr_matches_patient_named_pdf_reports(tmp_path):
    """``preprocess_phenikaa`` with the shipped OCR weights (on the CPU) over
    two vector PDF reports (``pdf.fonttype`` 42 and 3) named after their
    patients: each ID read through the PDF crop path (no mock of
    ``extract_from_pdf_crop``), each patient's folder copied, the table kept
    to their IDs."""
    import json

    from spine_vision_torch.data.phenikaa.matching import ascii_fold

    record = json.loads((PDF_FIXTURES / "record.json").read_text())["reports"]
    data = tmp_path / "raw"
    reports, tables = data / "labels" / "reports", data / "labels" / "tables"
    reports.mkdir(parents=True)
    tables.mkdir(parents=True)
    rows = ["Patient ID,IVD label,Modic"]
    crops = []
    for name in ("report_type42.pdf", "report_type3.pdf"):
        f = record[name]
        day, month, year = f["birthday"].split("/")
        shutil.copy(PDF_FIXTURES / name,
                    reports / ("_".join(ascii_fold(f["name"]).upper().split()) + f"_{day}{month}{year}.pdf"))
        _make_tree(data / "images", ["_".join(ascii_fold(f["name"]).upper().split())
                                     + f"_{year}_20240101/SAG T1"])
        rows += [f"{f['id']},1,0", f"{f['id']},2,1"]
    rows.append("250000001,1,0")
    (tables / "labels.csv").write_text("\n".join(rows) + "\n")
    extractor = DocumentExtractor(device="cpu")
    crop = extractor.extract_from_pdf_crop

    def spy(path, region, dpi=None):
        out = crop(path, region, dpi)
        crops.append((Path(path).suffix, tuple(region), out))
        return out

    extractor.extract_from_pdf_crop = spy
    config = tp.PreprocessConfig(data_path=data, output_path=tmp_path / "interim")
    result = tp.preprocess_phenikaa(config, extractor=extractor)
    ids = sorted(record[n]["id"] for n in ("report_type42.pdf", "report_type3.pdf"))
    assert result.num_samples == 2 and sorted(p.name for p in
                                              config.output_image_path.iterdir()) == ids
    assert sorted(out[0] for _, _, out in crops) == [f"Số phiếu: {i}" for i in ids]
    assert all(region == tp.DEFAULT_PDF_ID_CROP_REGION for _, region, _ in crops)
    table = config.output_table_path.read_text().splitlines()
    assert sorted({line.split(",")[0] for line in table[1:]}) == ids


def test_pdf_dpi_rescales_the_crop_as_jax_does(monkeypatch, tmp_path):
    """``spine-vision-torch dataset phenikaa --pdf-dpi 150``: the crop is the
    200-dpi region scaled by 150 / 200, the pixels the JAX method cuts from
    the same page (its own ``extract_from_pdf_crop`` and
    ``_render_first_page`` on a stub ``fitz`` that serves the port's
    render)."""
    import sys
    import types

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_fitz_stub import fitz_stub

    from spine_vision_torch import cli

    monkeypatch.setitem(sys.modules, "fitz", fitz_stub())
    data = tmp_path / "raw"
    (data / "labels" / "reports").mkdir(parents=True)
    (data / "labels" / "tables").mkdir(parents=True)
    (data / "images" / "NGUYEN_VAN_AN_1980_20240101").mkdir(parents=True)
    (data / "labels" / "tables" / "labels.csv").write_text("Patient ID,IVD label,Modic\n1,1,0\n")
    report = data / "labels" / "reports" / "NGUYEN_VAN_AN_15051980.pdf"
    shutil.copy(PDF_FIXTURES / "report_type42.pdf", report)
    seen = []
    monkeypatch.setattr(DocumentExtractor, "extract_from_image",
                        lambda self, image: seen.append(np.array(image)) or [])
    monkeypatch.setattr(DocumentExtractor, "extract_lines", lambda self, path: [])
    import logging

    # The CLI's setup_logger stops records at the package logger: restore it,
    # so that later tests in this worker still capture records.
    package = logging.getLogger("spine_vision_torch")
    saved = (package.handlers[:], package.level, package.propagate)
    try:
        assert cli.cli(["--device", "cpu", "dataset", "phenikaa", "--data-path", str(data),
                        "--output-path", str(tmp_path / "out"), "--pdf-dpi", "150"]) == 0
    finally:
        package.handlers[:], package.propagate = saved[0], saved[2]
        package.setLevel(saved[1])
    fake = types.SimpleNamespace(pdf_dpi=150, _page_cache=None, regions=[])
    fake._render_first_page = lambda path, dpi: JaxDocumentExtractor._render_first_page(
        fake, path, dpi)
    fake.extract_from_image = lambda image: fake.regions.append(np.array(image)) or []
    JaxDocumentExtractor.extract_from_pdf_crop(fake, report, tp.DEFAULT_PDF_ID_CROP_REGION)
    assert len(seen) == 1 and seen[0].shape == (150, 300, 3)  # (825, 150, 1125, 300)
    np.testing.assert_array_equal(seen[0], fake.regions[0])


def test_orbax_checkpoint_raises_naming_item_10(tmp_path):
    """An Orbax directory raises, naming its ROADMAP Queue 1 entry (it named
    item 10 until the port's OCR trainers, which write .npz, landed)."""
    ckpt = tmp_path / "orbax_ckpt"
    ckpt.mkdir()
    entry = "reading JAX Orbax checkpoint directories"
    with pytest.raises(NotImplementedError, match=entry):
        tp._load_ocr_variables(ckpt)
    config = tp.PreprocessConfig(data_path=tmp_path, detection_checkpoint=ckpt)
    with pytest.raises(NotImplementedError, match=entry):
        tp._build_extractor(config, device="cpu")
    shipped = tp._load_ocr_variables(
        Path(__file__).resolve().parents[1] / "spine_vision_tpu" / "weights" / "ocr_detector.npz")
    assert "params" in shipped
