"""ViT's class token and position table stay f32 parameters in a bf16 model.

Flax's ``self.param`` keeps ``cls_token`` and ``pos_embed`` in its default
``param_dtype``, f32, whatever the module's ``dtype``: the JAX ViT resizes
the f32 table with ``jax.image.resize`` and casts it to bf16 where it adds
it to the tokens. The port does the same when it is built without a
``param_dtype``. ViT-base at 128² (an 8x8 grid, shrunk from the 14x14
training grid) at batch 1, bf16, from one seeded Flax-layout tree; the
modules are built on the meta device (no constructor draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_zoo_helpers import carry, forward_pair, images, rel_err

from spine_vision_torch.models import vit as tv
from spine_vision_tpu.models import vit as jv

HW = 128
GRID = HW // 16

# The logits' gap to JAX, max |port - JAX| over max |JAX|: 1.2763e-2 with
# the table in bf16 (rounded, resized in bf16, then cast), 1.3785e-2 with it
# in f32 (measured on the CPU). The table's rounding is below the bf16
# stream's own: the first block's output already differs from JAX's in 57% of its
# elements, by up to 2.5 bf16 steps, either way. The bound is 1.25 times the
# repaired gap, under the 2e-2 that test_torch_zoo_transformers.py holds the
# small bf16 ViTs to.
LOGIT_BOUND = 1.75e-2


def _pair():
    with torch.device("meta"):
        port = tv.ViT(tv.VIT_CONFIGS["vit_base"], dtype=torch.bfloat16)
    port = port.to_empty(device="cpu")
    ref = jv.ViT(config=jv.VIT_CONFIGS["vit_base"], dtype=jnp.bfloat16)
    return port, ref, carry(port, ref, (1, HW, HW, 3), seed=21, train=False)


def test_bf16_vit_keeps_its_position_table_in_f32():
    port, ref, variables = _pair()
    assert port.cls_token.dtype == torch.float32
    assert port.pos_embed.dtype == torch.float32
    # The resized table: the f32 table through jax.image.resize, to f32
    # rounding (the weights are the same; the sums run in another order).
    pe = np.asarray(variables["params"]["pos_embed"], np.float32)
    d = pe.shape[-1]
    grid = jax.image.resize(jnp.asarray(pe[:, 1:].reshape(1, 14, 14, d)), (1, GRID, GRID, d),
                            "bilinear")
    want = np.concatenate([pe[:, :1], np.asarray(grid).reshape(1, GRID * GRID, d)], axis=1)
    with torch.no_grad():
        got = port.position_embeddings(GRID, GRID)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    # The logits sit within the repaired gap of JAX's.
    out, want_out, _ = forward_pair(port, ref, images(7, (1, HW, HW, 3)), variables)
    assert rel_err(out.numpy(), want_out) <= LOGIT_BOUND
