"""``spine_vision_torch/cli`` against ``spine_vision_tpu/cli``.

The rendering of config dataclasses to argparse (``tests/test_cli.py``'s
cases on a dataclass), the two parser trees option for option, each
subcommand's routing (the callees replaced in both packages, the configs
compared field for field with the JAX config's ``model_dump()``), and a
``--device cpu train localization`` run followed by ``evaluate``.

The stated differences of the port's CLI (``STATED``): a top-level
``--device``; ``train-ocr --output-dir`` required (None would overwrite the
shipped weights); ``bench`` raises (item 6 of ROADMAP Queue 1; the JAX
command runs ``bench.py``). Two defaults of the training configs differ
too: ``visualize_predictions`` is off (the card's host has no matplotlib)
and ``tracker_project`` names the port.
"""

import argparse
import csv
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace
from typing import Literal

import numpy as np
import pytest
import torch

import spine_vision_torch.cli as tcli
import spine_vision_tpu.cli as jcli
from spine_vision_torch.cli.config_args import add_config_args, config_from_args
from spine_vision_torch.data.png import write_png

STATED = {
    ((), "--device"): "the port's device option",
    (("train-ocr",), "--output-dir"): "required in the port",
}
DEFAULTS = {"--visualize-predictions": (False, True),
            "--no-visualize-predictions": (False, True),
            "--tracker-project": ("spine-vision-torch", "spine-vision-tpu")}


@pytest.fixture(autouse=True)
def _keep_loggers():
    """Both CLIs call their package's ``setup_logger``, which stops records
    at the package logger; restore each logger after the test, so that the
    tests run after these in the same worker still capture records."""
    import logging

    loggers = [logging.getLogger(n) for n in ("spine_vision_torch", "spine_vision_tpu")]
    saved = [(lg.handlers[:], lg.level, lg.propagate) for lg in loggers]
    yield
    for lg, (handlers, level, propagate) in zip(loggers, saved):
        lg.handlers[:] = handlers
        lg.setLevel(level)
        lg.propagate = propagate


@dataclasses.dataclass
class _DemoConfig:
    name: str = "x"
    count: int = 3
    rate: float = 0.5
    path: Path = Path("data")
    flag: bool = True
    maybe: int | None = None
    pair: tuple[int, int] = (4, 5)
    mode: Literal["a", "b"] = "a"
    items: list[str] = dataclasses.field(default_factory=list)


def _parse(args):
    parser = argparse.ArgumentParser()
    add_config_args(parser, _DemoConfig)
    return parser.parse_args(args)


def test_defaults_roundtrip():
    assert config_from_args(_DemoConfig, _parse([])) == _DemoConfig()


def test_all_field_kinds():
    namespace = _parse(["--name", "y", "--count", "7", "--rate", "0.25", "--path", "/tmp/z",
                        "--no-flag", "--maybe", "9", "--pair", "1", "2", "--mode", "b",
                        "--items", "p", "q"])
    config = config_from_args(_DemoConfig, namespace)
    assert config.name == "y" and config.count == 7
    assert config.rate == 0.25 and config.path == Path("/tmp/z")
    assert config.flag is False and config.maybe == 9
    assert config.pair == (1, 2)  # re-tupled from argparse's list
    assert config.mode == "b" and config.items == ["p", "q"]


@pytest.mark.parametrize("argv", [["--mode", "z"], ["--pair", "1"]])
def test_literal_choices_and_tuple_arity_enforced(argv, capsys):
    with pytest.raises(SystemExit):
        _parse(argv)


def test_full_parser_builds_and_routes():
    parser = tcli._build_parser()
    args = parser.parse_args(["train", "localization", "--batch-size", "4", "--no-augment"])
    assert args.command == "train" and args.subcommand == "localization"
    assert args.batch_size == 4 and args.augment is False and args.device == "cuda"
    args = parser.parse_args(["--device", "cpu", "infer", "--loc-checkpoint", "a",
                              "--cls-checkpoint", "b", "--t1", "x.mha", "--t2", "y.mha",
                              "--padded-hw", "1536", "1536"])
    assert args.command == "infer" and args.padded_hw == [1536, 1536] and args.device == "cpu"
    with pytest.raises(SystemExit):
        parser.parse_args(["bogus"])


def _options(parser, path=()):
    """{(subcommand path, option string): (default, choices, nargs, required)}."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_options(sub, (*path, name)))
        elif not isinstance(action, argparse._HelpAction):
            key = (action.default, action.choices and list(action.choices), action.nargs,
                   action.required, type(action).__name__)
            for opt in action.option_strings:
                out[(path, opt)] = key
    return out


def test_parser_trees_match_jax():
    got, want = _options(tcli._build_parser()), _options(jcli._build_parser())
    assert set(got) - set(want) == {((), "--device")}
    assert set(want) == set(got) - {((), "--device")}
    for key, value in want.items():
        if key in STATED:
            assert value[3] is False and got[key][3] is True  # required in the port
            continue
        if key[1] in DEFAULTS:
            assert (got[key][0], value[0]) == DEFAULTS[key[1]], key
            assert got[key][1:] == value[1:], key
            continue
        assert got[key] == value, key


def _record(calls, name, ret=None):
    def fn(*args, **kw):
        calls.append((name, args, kw))
        return ret
    return fn


ROUTES = {
    "dataset localization": ["dataset", "localization", "--base-path", "b",
                             "--no-include-spinal-canal"],
    "dataset phenikaa": ["dataset", "phenikaa", "--data-path", "p", "--pdf-dpi", "150",
                         "--pdf-id-crop-region", "1", "2", "300", "40"],
    "dataset classification": ["dataset", "classification", "--base-path", "b",
                               "--image-size", "64", "64"],
    "train localization": ["train", "localization", "--run-id", "r", "--batch-size", "4",
                           "--image-size", "64", "64", "--no-visualize-predictions",
                           "--tracker-project", "t", "--series-types", "sag_t1"],
    "train classification": ["train", "classification", "--run-id", "r",
                             "--target-labels", "pfirrmann", "modic",
                             "--no-visualize-predictions", "--tracker-project", "t"],
    "evaluate localization": ["evaluate", "localization", "--run-id", "r",
                              "--checkpoint-path", "c", "--no-visualize-predictions",
                              "--tracker-project", "t"],
    "evaluate classification": ["evaluate", "classification", "--run-id", "r",
                                "--checkpoint-path", "c", "--no-visualize-predictions",
                                "--tracker-project", "t"],
    "test": ["test", "--checkpoint-path", "c", "--images", "a.png", "b.jpg",
             "--model-kind", "localization", "--image-size", "64", "48"],
    "infer": ["infer", "--loc-checkpoint", "l", "--cls-checkpoint", "c", "--t1", "a", "b",
              "--t2", "c", "d", "--crop-mode", "rotated", "--output-json", "o/p.json"],
    "serve": ["serve", "--loc-checkpoint", "l", "--cls-checkpoint", "c", "--watch-dir", "w",
              "--output-dir", "o", "--once", "--max-batch", "4"],
    "convert": ["convert", "--checkpoint", "r.pth", "--arch", "resnet18", "--output", "r.npz"],
    "parity": ["parity", "--output-dir", "o", "--seed", "3", "--norm-impl", "flax"],
    "train-ocr": ["train-ocr", "--output-dir", "o", "--recognizer-steps", "5"],
}


def _patch(monkeypatch, pkg, calls):
    """Replace every callee of the CLI in package ``pkg`` with a recorder."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    result = SimpleNamespace(summary="s")
    for name in ("create_localization_dataset", "create_classification_dataset"):
        monkeypatch.setattr(mod("data.builders"), name, _record(calls, name, result))
    monkeypatch.setattr(mod("data.phenikaa"), "preprocess_phenikaa",
                        _record(calls, "preprocess_phenikaa", result))
    for name in ("train_localization", "train_classification", "evaluate_localization",
                 "evaluate_classification", "test_inference_command"):
        monkeypatch.setattr(mod("cli.train"), name, _record(calls, name, {}))
    study = SimpleNamespace(t1_slice=np.zeros((300, 280)), t2_slice=np.zeros((600, 520)))
    monkeypatch.setattr(mod("infer"), "study_input_from_paths",
                        _record(calls, "study_input_from_paths", study))
    pipe = SimpleNamespace(run=_record(calls, "run", []))
    monkeypatch.setattr(mod("infer").StudyInferencePipeline, "from_checkpoints",
                        _record(calls, "from_checkpoints", pipe))
    monkeypatch.setattr(mod("infer.serve"), "serve_directory", _record(
        calls, "serve_directory", SimpleNamespace(processed=0, failed=0, batches=0)))
    monkeypatch.setattr(mod("models.convert"), "convert_checkpoint",
                        _record(calls, "convert_checkpoint"))
    monkeypatch.setattr(mod("utils.parity"), "run_parity",
                        _record(calls, "run_parity", {"all_pass": True}))
    monkeypatch.setattr(mod("train.ocr"), "train_ocr_stack", _record(calls, "train_ocr_stack", {}))


def _normal(value):
    """Configs as their JAX ``model_dump()`` keys; the rest as it is."""
    if hasattr(value, "model_dump"):
        return {k: _normal(v) for k, v in value.model_dump().items()}
    return value


def _port_normal(value, keys):
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {k: _normal(getattr(value, k)) for k in keys}
    return value


@pytest.mark.parametrize("route", list(ROUTES))
def test_subcommands_route_as_jax(monkeypatch, tmp_path, route):
    monkeypatch.chdir(tmp_path)
    got_calls, want_calls = [], []
    _patch(monkeypatch, "spine_vision_torch", got_calls)
    _patch(monkeypatch, "spine_vision_tpu", want_calls)
    argv = ROUTES[route]
    if argv[0] in ("dataset", "train", "evaluate"):
        # BaseConfig's log_path defaults to the working directory's "logs":
        # the JAX package's when its module was imported.
        argv = [*argv, "--log-path", "lp"]
    assert tcli.cli(["--device", "cpu", *argv]) == 0
    assert jcli.cli(argv) == 0
    assert [c[0] for c in got_calls] == [c[0] for c in want_calls]
    for (name, g_args, g_kw), (_, w_args, w_kw) in zip(got_calls, want_calls):
        g_kw, w_kw = dict(g_kw), dict(w_kw)
        assert g_kw.pop("device", "cpu") in ("cpu", torch.device("cpu")), name
        w_kw.pop("mesh", None), g_kw.pop("mesh", None)
        if name in ("run", "serve_directory"):  # the recorded pipeline and studies
            g_args, w_args = g_args[1:], w_args[1:]
        w_args = [_normal(a) for a in w_args]
        g_args = [_port_normal(a, w.keys() if isinstance(w, dict) else ())
                  for a, w in zip(g_args, w_args)]
        assert g_args == w_args, name
        if "config" in w_kw:  # the study pipelines' config
            for key in ("crop_mode", "padded_hw"):
                assert getattr(g_kw["config"], key) == getattr(w_kw["config"], key)
            g_kw.pop("config"), w_kw.pop("config")
        if name == "train_ocr_stack":
            assert g_kw.pop("output_dir") == w_kw.pop("output_dir") == Path("o")
        assert g_kw == w_kw, name
    if route == "infer":
        assert json.loads((tmp_path / "o" / "p.json").read_text()) == []


def test_bench_raises_item_6():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tcli.cli(["bench"])


def _loc_data(root: Path, n: int = 40, hw: int = 32) -> Path:
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    rows = []
    for i in range(n):
        name = f"images/img{i}.png"
        write_png(root / name, rng.integers(0, 256, (hw, hw), dtype=np.uint8))
        for k, level in enumerate(("L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1")):
            rows.append({"image_path": name, "level": level, "relative_x": 0.5,
                         "relative_y": 0.15 + 0.15 * k, "series_type": "sag_t2",
                         "source": "synth"})
    with open(root / "annotations.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return root


def test_cpu_train_then_evaluate_localization(tmp_path, monkeypatch):
    """``--device cpu train localization`` (ConvNeXt-T at 32^2, the tracker
    on) and ``evaluate`` of its checkpoint: the test metrics of the trainer."""
    from spine_vision_torch.train.localization import LocalizationTrainer

    data = _loc_data(tmp_path / "data")
    run = tmp_path / "run"
    common = ["--data-path", str(data), "--backbone", "convnext_tiny", "--no-pretrained",
              "--image-size", "32", "32", "--batch-size", "4", "--num-epochs", "1",
              "--num-workers", "0", "--no-mixed-precision", "--seed", "0"]
    seen = []
    real = LocalizationTrainer.evaluate
    monkeypatch.setattr(LocalizationTrainer, "evaluate",
                        lambda self, *a: seen.append(real(self, *a)) or seen[-1])
    assert tcli.cli(["--device", "cpu", "train", "localization", *common,
                     "--output-path", str(run), "--use-tracker"]) == 0
    records = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
               .splitlines()]
    assert {"train/loss", "val/loss", "val/med", "step"} <= set(records[0])
    assert any("test/med" in r for r in records)
    assert any(r.get("_finished") == 1.0 for r in records)
    assert (run / "best_model" / "state.pt").exists()
    assert tcli.cli(["--device", "cpu", "evaluate", "localization", *common,
                     "--output-path", str(tmp_path / "eval"),
                     "--checkpoint-path", str(run / "best_model")]) == 0
    assert len(seen) == 2 and seen[0] == seen[1] and "med" in seen[0]


def test_without_a_card_the_cli_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.cli(["train", "localization"])
