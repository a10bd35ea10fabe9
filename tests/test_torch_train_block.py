"""Localization training with the whole-block training kernel
(``use_pallas="block"``) against the JAX package's.

The JAX ConvNeXt runs ``convnext_block_train`` on the v1 blocks of C <= 512
with its Pallas kernels in interpret mode; the port, on the CPU, runs the
kernels' plain versions. The JAX trainer never picks this mode itself: a model
built with it is handed to the trainer, on both sides. This file sits beside
the other train-step comparisons so that a run spread over workers by file
takes them at once.
"""

import numpy as np
import torch

from spine_vision_torch.models.classifier import CoordinateRegressor
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_torch.models.convnext import ConvNeXtBlock
from spine_vision_torch.train.localization import LocalizationConfig, LocalizationTrainer
from test_torch_train import _Set, check_one_train_step_against_jax


def test_one_train_step_matches_jax_block_mode():
    """convnext_tiny at 32^2: 15 whole-block training blocks (C = 96, 192,
    384) and 3 plain ones (C = 768); tolerances as the hybrid comparison's."""
    check_one_train_step_against_jax("block")


def test_cpu_trainer_epoch_with_a_block_mode_model(tmp_path):
    run = tmp_path / "run"
    model = CoordinateRegressor("convnext_tiny", dtype=torch.float32, device="cpu",
                                use_pallas="block", param_dtype=torch.float32)
    load_flax_variables(model, random_flax_variables(model, seed=3)[0])
    blocks = [m for m in model.modules() if isinstance(m, ConvNeXtBlock)]
    assert [b.route for b in blocks] == ["block"] * 15 + ["plain"] * 3
    assert [b.dim for b in blocks if b.route == "block"] == [96] * 3 + [192] * 3 + [384] * 9
    cfg = LocalizationConfig(backbone="convnext_tiny", image_size=(32, 32), batch_size=4,
                             num_epochs=1, output_path=run, num_workers=2, seed=0,
                             pretrained=False, mixed_precision=False)
    trainer = LocalizationTrainer(cfg, model=model, train_dataset=_Set(8, 32, 0),
                                  val_dataset=_Set(5, 32, 1), device="cpu")
    result = trainer.train()
    for key in ("train_loss", "val_loss", "lr", "med"):
        values = result.history[key]
        assert len(values) == 1 and np.isfinite(values[0]), key
    assert all(p.grad is not None for p in trainer.model.parameters())
    saved = torch.load(run / "best_model" / "state.pt", weights_only=True)["model"]
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, saved[name], rtol=0, atol=0)
    assert trainer.state.step == 2
