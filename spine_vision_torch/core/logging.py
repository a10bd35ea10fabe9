"""The package logger and its console and file sinks.

Counterpart of ``spine_vision_tpu/core/logging.py``: ``setup_logger(verbose)``
attaches a console handler, ``add_file_log(path)`` a rotating file sink (10 MB,
5 backups), and ``logger`` is the ``spine_vision_torch`` logger every module
of the port writes to. The console handler writes plain lines to stderr (the
JAX package routes them through tqdm where it is importable; the port never
imports tqdm). Importing the module attaches nothing: a program that wants
the console lines calls ``setup_logger``.
"""

from __future__ import annotations

import logging
import sys
from logging.handlers import RotatingFileHandler
from pathlib import Path

logger = logging.getLogger("spine_vision_torch")

_CONSOLE_FORMAT = "%(asctime)s | %(levelname)-8s | %(message)s"
_FILE_FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s:%(lineno)d | %(message)s"
_DATE_FORMAT = "%H:%M:%S"


class _ConsoleHandler(logging.StreamHandler):
    """Plain stderr lines; resolves ``sys.stderr`` at each record, so a
    redirected stream (pytest's capture, a notebook) receives them."""

    def __init__(self) -> None:
        super().__init__(sys.stderr)

    def emit(self, record: logging.LogRecord) -> None:
        self.stream = sys.stderr
        super().emit(record)


def setup_logger(verbose: bool = False) -> None:
    """Attach the console handler (DEBUG when ``verbose``, else INFO),
    replacing one attached before; records then stop at this logger."""
    for handler in list(logger.handlers):
        if isinstance(handler, _ConsoleHandler):
            logger.removeHandler(handler)
    handler = _ConsoleHandler()
    handler.setFormatter(logging.Formatter(_CONSOLE_FORMAT, datefmt=_DATE_FORMAT))
    handler.setLevel(logging.DEBUG if verbose else logging.INFO)
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False


def add_file_log(
    log_path: Path | str | None = None,
    log_filename: str = "spine_vision_torch.log",
) -> None:
    """Add a rotating file sink (10 MB a file, 5 backups) in ``log_path``
    (default ``cwd/logs``)."""
    log_path = Path.cwd() / "logs" if log_path is None else Path(log_path)
    log_path.mkdir(parents=True, exist_ok=True)
    handler = RotatingFileHandler(
        log_path / log_filename, maxBytes=10 * 1024 * 1024, backupCount=5, encoding="utf-8"
    )
    handler.setFormatter(logging.Formatter(_FILE_FORMAT, datefmt="%Y-%m-%d %H:%M:%S"))
    handler.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    if logger.level == logging.NOTSET or logger.level > logging.DEBUG:
        logger.setLevel(logging.DEBUG)
    logger.info("Logging to %s", log_path)
