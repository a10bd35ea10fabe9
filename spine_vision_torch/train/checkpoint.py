"""Checkpoint save and restore with the JAX package's run-dir layout.

Counterpart of ``spine_vision_tpu/train/checkpoint.py``:

    <run dir>/
        best_model/                 state.pt (torch.save of the train state)
        best_model.meta.json        epoch, best metric, history, config
        checkpoint_epoch_N/ (+ .meta.json)
        config.yaml
        logs/

``state.pt`` holds the model's parameters (f32 masters) and BatchNorm
running statistics (its ``state_dict``), the optimizer's moments, the
update count, the learning rate and the generator's state.
It is read back with ``weights_only=True``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from spine_vision_torch.train.state import TrainState

STATE_FILE = "state.pt"


def _json_default(obj: Any) -> Any:
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, Path):
        return str(obj)
    raise TypeError(f"Cannot serialize {type(obj)}")


def save_checkpoint(path: Path, state: TrainState, meta: dict[str, Any]) -> None:
    """Write ``path/state.pt`` and the ``<path>.meta.json`` sidecar."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "lr_override": state.lr_override,
        "last_lr": state.last_lr,
    }
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path / STATE_FILE)
    (path.parent / f"{path.name}.meta.json").write_text(json.dumps(meta, default=_json_default))


def load_checkpoint(path: Path, state: TrainState) -> dict[str, Any]:
    """Restore ``state`` in place from ``path``; return the metadata ({} when
    the sidecar is missing)."""
    path = Path(path).absolute()
    payload = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    state.lr_override = payload["lr_override"]
    state.last_lr = float(payload["last_lr"])
    meta_path = path.parent / f"{path.name}.meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}
