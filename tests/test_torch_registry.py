"""The port's registries (``spine_vision_torch/core/registry.py``) against
the JAX package's: the counterparts of ``tests/test_registry.py``. Importing
the modules registers the same names in both packages; and the port's
``core`` logging and config counterparts."""

import logging

import pytest

import spine_vision_torch.metrics  # noqa: F401
import spine_vision_torch.models.classifier  # noqa: F401
import spine_vision_torch.models.textdet  # noqa: F401
import spine_vision_torch.models.textrec  # noqa: F401
import spine_vision_torch.train.classification as tcls
import spine_vision_torch.train.localization as tloc
import spine_vision_tpu.metrics  # noqa: F401
import spine_vision_tpu.models  # noqa: F401
import spine_vision_tpu.train.classification  # noqa: F401
import spine_vision_tpu.train.localization  # noqa: F401
from spine_vision_torch import core
from spine_vision_tpu import core as jcore


def test_builtin_registrations():
    for name in ("MODEL_REGISTRY", "TRAINER_REGISTRY", "METRICS_REGISTRY"):
        assert getattr(core, name).names() == getattr(jcore, name).names(), name
    assert core.MODEL_REGISTRY.get("coordinate_regressor").__name__ == "CoordinateRegressor"
    assert core.MODEL_REGISTRY.get("text_recognition").__name__ == "TextRecognitionNet"


def test_trainer_config_class():
    assert core.get_trainer_config_class("localization") is tloc.LocalizationConfig
    assert core.get_trainer_config_class("classification") is tcls.ClassificationConfig
    assert core.TRAINER_REGISTRY.get("localization") is tloc.LocalizationTrainer
    assert core.get_trainer_config_class("nothing") is None


def test_unknown_name_lists_available():
    registry = core.Registry("widget")

    @registry.register("a")
    class A:
        pass

    with pytest.raises(KeyError, match="Available: a"):
        registry.get("zzz")
    assert registry.create("a").__class__ is A
    assert registry.names() == ["a"] and "a" in registry and "b" not in registry


def test_metrics_create_and_trainer_from_config():
    metrics = core.METRICS_REGISTRY.create("classifier", target_labels=["pfirrmann"])
    assert hasattr(metrics, "update") and hasattr(metrics, "compute")
    made = []

    @core.register_trainer("probe_task", config_cls=dict)
    class Probe:
        def __init__(self, config, **kw):
            made.append((config, kw))

    class Cfg:
        task = "probe_task"

    cfg = Cfg()
    try:
        assert isinstance(core.create_trainer_from_config(cfg, device="cpu"), Probe)
        assert made == [(cfg, {"device": "cpu"})]
        assert core.get_trainer_config_class("probe_task") is dict
    finally:
        core.TRAINER_REGISTRY._entries.pop("probe_task")
        core.TRAINER_REGISTRY._extras.pop("probe_task")


def test_logging_and_base_config(tmp_path, capsys):
    """``setup_logger`` writes plain stderr lines, ``add_file_log`` a file;
    ``BaseConfig`` has the JAX fields, defaults and CLI aliases."""
    logger = core.logger
    saved = (list(logger.handlers), logger.level, logger.propagate)
    try:
        core.setup_logger(verbose=True)
        core.setup_logger(verbose=False)  # replaces the console handler
        logger.info("hello console")
        logger.debug("not shown")
        core.add_file_log(tmp_path, "run.log")
        logger.debug("into the file")
        err = capsys.readouterr().err
        assert "INFO     | hello console" in err and "not shown" not in err
        for h in logger.handlers:
            h.flush()
        assert "into the file" in (tmp_path / "run.log").read_text()
    finally:
        for h in logger.handlers:
            if h not in saved[0]:
                h.close()
        logger.handlers[:] = saved[0]
        logger.setLevel(saved[1])
        logger.propagate = saved[2]
    assert logging.getLogger("spine_vision_torch") is logger
    cfg, jcfg = core.BaseConfig(), jcore.BaseConfig()
    assert (cfg.verbose, cfg.enable_file_log, cfg.log_path) == (
        jcfg.verbose, jcfg.enable_file_log, jcfg.log_path)
    assert core.BaseConfig.cli_aliases == jcore.BaseConfig.cli_aliases
