"""One ResNet-18 classification train step of the port against the JAX
package's ``train/steps.py::make_train_step(has_batch_stats=True)``.

The same seeded Flax-layout weights and running statistics (carried by
``load_flax_variables``), the same uint8 batch with all 8 tasks' targets, f32
at 32², dropout 0, no augmentation, the training overrides (label smoothing
0.1), global-norm clipping and ``optax.adamw``: the loss, every parameter
after the update and every running statistic. Then two steps with the
backbone frozen and one unfrozen, against the JAX step's frozen form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spine_vision_torch.core.tasks import AVAILABLE_TASK_NAMES, get_task
from spine_vision_torch.models.classifier import Classifier as TClassifier
from spine_vision_torch.models.classifier import make_multitask_loss_fn as t_multitask
from spine_vision_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
    random_flax_variables,
)
from spine_vision_torch.ops.image import imagenet_normalize as t_normalize
from spine_vision_torch.train import schedules as tsched
from spine_vision_torch.train.classification import create_tasks_for_training as t_create
from spine_vision_torch.train.state import TrainState as TState
from spine_vision_torch.train.steps import train_step as t_train_step
from spine_vision_tpu.models import Classifier
from spine_vision_tpu.models.classifier import make_multitask_loss_fn as j_multitask
from spine_vision_tpu.ops.image import imagenet_normalize as j_normalize
from spine_vision_tpu.train.classification import create_tasks_for_training as j_create
from spine_vision_tpu.train.state import TrainState as JState
from spine_vision_tpu.train.steps import make_train_step

LR, WD, CLIP = 1e-3, 1e-5, 1.0
N, HW = 4, 32


def _batch(seed):
    rng = np.random.default_rng(seed)
    targets = {}
    for name in AVAILABLE_TASK_NAMES:
        task = get_task(name)
        if task.is_multiclass:
            targets[name] = rng.integers(0, task.num_classes, N).astype(np.int32)
        else:
            targets[name] = rng.integers(0, 2, N).astype(np.float32)
    return {"image": rng.integers(0, 256, (N, HW, HW, 3), dtype=np.uint8), "targets": targets}


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in leaves}


class _Pair:
    """The port's model and train state, and the JAX model, step and state,
    from the same weights."""

    def __init__(self, seed):
        self.port = TClassifier("resnet18", tasks=tuple(t_create()), dtype=torch.float32,
                                device="cpu", dropout=0.0, param_dtype=torch.float32)
        params, stats = random_flax_variables(self.port, seed)
        load_flax_variables(self.port, params, stats)
        self.state = TState(
            model=self.port, optimizer=tsched.build_optimizer(self.port.parameters(), LR, WD),
            schedule=lambda count: LR, generator=torch.Generator().manual_seed(0),
            grad_clip=CLIP,
        )
        loss = t_multitask(t_create())
        self.t_loss = lambda out, b: loss(out, b["targets"])

        self.ref = Classifier(backbone_name="resnet18", tasks=tuple(j_create()),
                              dtype=jnp.float32, dropout=0.0)
        j_loss = j_multitask(j_create())
        tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=WD))
        self.jstate = JState.create(params=jax.tree_util.tree_map(jnp.asarray, params), tx=tx,
                                    batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
        self._j_steps = {
            frozen: make_train_step(self.ref.apply, lambda out, b: j_loss(out, b["targets"]),
                                    has_batch_stats=True, frozen_backbone=frozen,
                                    preprocess=self._j_pre)
            for frozen in (False, True)
        }

    @staticmethod
    def _j_pre(b, key, train):
        return {**b, "image": j_normalize(b["image"].astype(jnp.float32) / 255.0)}

    @staticmethod
    def _t_pre(b, gen, train):
        return {**b, "image": t_normalize(b["image"].float() / 255.0)}

    def step(self, batch, frozen=False):
        jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
        self.jstate, jloss = self._j_steps[frozen](self.jstate, jbatch)
        tloss = t_train_step(self.state, batch, self.t_loss, self._t_pre,
                             frozen=list(self.port.backbone.parameters()) if frozen else ())
        return tloss.item(), float(jloss)

    def _moments(self):
        """Adam's first moments of both, in the Flax layout."""
        port = {id(p): p.grad for p in self.port.parameters()}
        for p in self.port.parameters():
            p.grad = self.state.optimizer.state[p]["exp_avg"]
        got = _flat(export_flax_variables(self.port, grads=True)[0])
        for p in self.port.parameters():
            p.grad = port[id(p)]
        return got, _flat(self.jstate.opt_state[1][0].mu)

    def check(self, atol, updates):
        """Adam's first moments (the clipped gradients' running mean) and the
        parameters.

        A ReLU input within f32 rounding of 0 can take either side in two
        f32 implementations and route its gradient differently; all that is
        upstream of it then moves by a few per cent of its norm. In the
        first test one residual ReLU input of 8192 at stage 2 (8.3e-5 in
        f64) flips, and the port's f32 gradients of the stem and stages 1-2
        differ by up to 2.6e-2 of their norms from JAX's, and as much from
        the port's own step with f64 convolutions. So: each parameter's
        moment within 5e-2 of its norm, the median over parameters within
        1e-3; each parameter within ``atol`` where the sign of its moment is
        settled (|mu| above a quarter of the tensor's largest), and
        everywhere within ``updates`` Adam steps (an update moves an element
        by at most lr, so a moment that flips sign gives up to 2 lr)."""
        got_m, want_m = self._moments()
        assert got_m.keys() == want_m.keys()
        errs = {path: np.linalg.norm(got_m[path] - w) / max(np.linalg.norm(w), 1e-30)
                for path, w in want_m.items()}
        assert max(errs.values()) <= 5e-2, max(errs.items(), key=lambda kv: kv[1])
        assert np.median(list(errs.values())) <= 1e-3, np.median(list(errs.values()))
        params, stats = export_flax_variables(self.port)
        got, want = _flat(params), _flat(self.jstate.params)
        assert got.keys() == want.keys()
        for path, w in want.items():
            mu = np.abs(want_m[path])
            settled = mu > 0.25 * mu.max()
            np.testing.assert_allclose(got[path][settled], w[settled], atol=atol, err_msg=path)
            assert np.abs(got[path] - w).max() <= 2 * LR * updates + atol, path
        got_s, want_s = _flat(stats), _flat(self.jstate.batch_stats)
        assert got_s.keys() == want_s.keys() and len(got_s) == 2 * 20  # 20 BatchNorms
        for path, w in want_s.items():
            # 0.9 * old + 0.1 * batch moments of f32 activations: 1e-5.
            np.testing.assert_allclose(got_s[path], w, rtol=1e-5, atol=1e-5, err_msg=path)


def test_one_classification_train_step_matches_jax():
    pair = _Pair(seed=21)
    before = {n: p.detach().clone() for n, p in pair.port.named_parameters()}
    tloss, jloss = pair.step(_batch(22))
    # f32 forward through 20 convolutions and BatchNorms, sums in another
    # order: the loss within 1e-5 relative.
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert pair.state.step == 1
    # The first Adam update is about lr * g / |g|, which amplifies the
    # relative error of a gradient element near 0: a tenth of lr.
    pair.check(atol=0.1 * LR, updates=1)
    # Every parameter moved (BatchNorm scales and biases included), and the
    # model went back to nothing but its parameters' values.
    for name, p in pair.port.named_parameters():
        assert not torch.equal(p, before[name]), name


def test_frozen_backbone_steps_then_unfrozen_match_jax():
    """Two frozen steps: the backbone's weights stay bit for bit while its
    Adam moments decay on zero gradients and its running statistics move;
    the heads train. Then one unfrozen step. Each parameter within 0.1 * lr
    an update (three updates: 0.3 * lr)."""
    pair = _Pair(seed=23)
    backbone0 = {n: p.detach().clone() for n, p in pair.port.backbone.named_parameters()}
    stats0 = {n: b.clone() for n, b in pair.port.named_buffers()}
    for i in range(2):
        tloss, jloss = pair.step(_batch(24 + i), frozen=True)
        assert tloss == pytest.approx(jloss, rel=1e-5)
    for n, p in pair.port.backbone.named_parameters():
        assert torch.equal(p, backbone0[n]), n
        moments = pair.state.optimizer.state[p]
        assert moments["exp_avg"].abs().max() == 0 and int(moments["step"]) == 2, n
    for n, b in pair.port.named_buffers():
        assert not torch.equal(b, stats0[n]), n
    pair.check(atol=0.2 * LR, updates=2)
    tloss, jloss = pair.step(_batch(26), frozen=False)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    pair.check(atol=0.3 * LR, updates=3)
