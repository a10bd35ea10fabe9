"""Localization training with the all-kernel ConvNeXt block
(``use_pallas=True``, the trainer's ``use_pallas_dwconv=True``) against the
JAX package's.

The JAX ConvNeXt runs ``convnext_block_fused`` (C <= 512) and
``depthwise_conv7x7_ln`` (C = 768) with their Pallas kernels in interpret
mode; the port, on the CPU, runs the kernels' plain versions. This file sits
beside ``test_torch_train.py`` so that a run spread over workers by file
takes both train-step comparisons at once.
"""

import numpy as np
import pytest
import torch

from spine_vision_torch.models.convnext import ConvNeXtBlock
from spine_vision_torch.train.localization import (
    LocalizationConfig,
    LocalizationTrainer,
    resolve_use_pallas,
)
from test_torch_train import _Set, check_one_train_step_against_jax


def test_one_train_step_matches_jax_all_kernel_block():
    """convnext_tiny at 32^2 reaches the fused blocks (C = 96, 192, 384) and
    the dwconv+LN blocks (C = 768); tolerances as the hybrid comparison's."""
    check_one_train_step_against_jax(True)


@pytest.mark.parametrize(
    "mlp,dwconv,want",
    [(None, True, True), (True, True, True), (False, True, False),
     (None, False, "hybrid"), (False, False, False)],
)
def test_resolve_use_pallas_maps_the_flags(mlp, dwconv, want):
    assert resolve_use_pallas(mlp, dwconv) == want


def test_use_pallas_mlp_alone_names_kernel_7():
    """``use_pallas_mlp=True`` alone is the mode of kernel #7, the LN-fused MLP
    (``"mlp"``), as the JAX package's ``_resolve_use_pallas``."""
    assert resolve_use_pallas(True, False) == "mlp"


def test_cpu_trainer_epoch_with_use_pallas_dwconv_and_reload(tmp_path):
    run = tmp_path / "run"
    cfg = LocalizationConfig(backbone="convnext_tiny", image_size=(32, 32), batch_size=4,
                             num_epochs=1, output_path=run, num_workers=2, seed=0,
                             pretrained=False, use_pallas_dwconv=True)
    trainer = LocalizationTrainer(cfg, train_dataset=_Set(8, 32, 0),
                                  val_dataset=_Set(5, 32, 1), device="cpu")
    blocks = [m for m in trainer.model.modules() if isinstance(m, ConvNeXtBlock)]
    assert len(blocks) == 18
    assert [b.dim for b in blocks if b.route == "fused"] == [96] * 3 + [192] * 3 + [384] * 9
    assert [b.dim for b in blocks if b.route == "dw_ln"] == [768] * 3
    result = trainer.train()
    for key in ("train_loss", "val_loss", "lr", "med"):
        values = result.history[key]
        assert len(values) == 1 and np.isfinite(values[0]), key
    # Every parameter took its gradient: none is left as it was made.
    assert all(p.grad is not None for p in trainer.model.parameters())
    # The best model was reloaded: the weights are those saved.
    saved = torch.load(run / "best_model" / "state.pt", weights_only=True)["model"]
    for name, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, saved[name], rtol=0, atol=0)
    assert trainer.state.step == 2
