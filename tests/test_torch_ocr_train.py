"""OCR training in the port (``spine_vision_torch/train/ocr.py``) against the
JAX package's, on the CPU.

- ``ops/ctc.py`` against ``optax.ctc_loss``, loss and gradient;
- Flax's training ``BatchNorm`` (``models/layers.py::FlaxBatchNorm``)
  against ``flax.linen.BatchNorm``: outputs, running statistics, gradients;
- ``warmup_cosine_decay`` against optax's schedule at every count;
- the nets' own initialisation against Flax's laws;
- the ``.npz`` written by either package read by the other;
- ``train_ocr_stack`` end to end at a few steps.

A few train steps of each net against the JAX package's are in
``tests/test_torch_ocr_train_steps.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from spine_vision_torch.models.convert import (
    export_flax_variables,
    load_flax_variables,
    save_variables_npz,
)
from spine_vision_torch.models.layers import FlaxBatchNorm
from spine_vision_torch.models.textdet import TextDetectionNet
from spine_vision_torch.models.textrec import TextRecognitionNet
from spine_vision_torch.ops.ctc import ctc_loss
from spine_vision_torch.train import ocr
from spine_vision_torch.train.schedules import warmup_cosine_decay
from spine_vision_tpu.models.textdet import TextDetectionNet as JDet
from spine_vision_tpu.models.textrec import TextRecognitionNet as JRec
from spine_vision_tpu.train import ocr as jocr


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_init(model, shape, seed=0):
    """``model.init(PRNGKey(seed), zeros(shape), train=True)``, jitted (the
    same draws as the train functions' eager init, in a fraction of the
    time)."""
    return jax.jit(lambda key: model.init(key, jnp.zeros(shape), train=True))(
        jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


# ---------------------------------------------------------------------------
# CTC, BatchNorm, schedule, initialisation
# ---------------------------------------------------------------------------


def _ctc_case(kind, rng):
    b, k, n = 4, 12, 10
    t = 8 if kind == "infeasible" else 16  # more labels than frames
    logits = rng.normal(size=(b, t, k)).astype(np.float32) * 2
    lens = {"feasible": [3, 5, 1, 7], "infeasible": [10, 9, 12, 3],
            "empty": [0, 0, 4, 2], "repeated": [4, 6, 6, 3]}[kind]
    n = max(n, max(lens))
    labels = rng.integers(1, k, (b, n)).astype(np.int32)
    if kind == "repeated":
        labels[:, 1] = labels[:, 0]
        labels[:, 3] = labels[:, 2] = labels[:, 4]
    pad = (np.arange(n)[None] >= np.array(lens)[:, None]).astype(np.float32)
    labels = np.where(pad > 0, 0, labels).astype(np.int32)
    logit_pad = np.zeros((b, t), np.float32)
    if kind == "feasible":
        logit_pad[1, 12:] = 1.0  # a shorter input
    return logits, logit_pad, labels, pad


@pytest.mark.parametrize("kind", ["feasible", "infeasible", "empty", "repeated"])
def test_ctc_matches_optax(kind):
    logits, logit_pad, labels, pad = _ctc_case(kind, np.random.default_rng(1))

    def jloss(x):
        return optax.ctc_loss(x, logit_pad, labels, pad)

    want = np.asarray(jax.jit(jloss)(logits))
    want_grad = np.asarray(jax.grad(lambda x: jloss(x).sum())(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss(x, torch.from_numpy(logit_pad), torch.from_numpy(labels), torch.from_numpy(pad))
    got.sum().backward()
    if kind == "infeasible":  # optax's finite ~1e5 where F.ctc_loss gives inf
        assert (want[:3] > 1e4).all() and want[3] < 1e3 and np.isfinite(want).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-6, atol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=1e-4, atol=2e-6)


def test_flax_batchnorm_training_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, size=(4, 6, 10, 16)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    mod = FlaxBatchNorm(16)
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": rng.normal(size=16).astype(np.float32)}
    stats = {"mean": rng.normal(size=16).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    load_flax_variables(mod, params, stats)
    bn = nn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    xb = jnp.asarray(x, jnp.bfloat16)  # a bf16 convolution's output, as in the nets

    def apply(p, xin):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xin, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (want_y, upd)), (gp, gx) = jax.jit(
        jax.value_and_grad(apply, argnums=(0, 1), has_aux=True))(params, xb)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).requires_grad_(True)
    y = mod(xt, train=True)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=0, atol=2e-6)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(mod, name).numpy(),
                                   np.asarray(upd["batch_stats"][name]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mod.scale.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-4)
    np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5)
    # The input's cotangent is bf16 in Flax (each branch rounded, then the
    # sum): equal but for ties of the f32 sums a bf16 ulp apart.
    gx = np.asarray(gx.astype(jnp.float32))
    gap = np.abs(xt.grad.numpy() - gx) / np.abs(gx).max()
    assert (gap == 0).mean() > 0.98 and gap.max() <= 2 ** -7


@pytest.mark.parametrize("steps,warmup", [(4000, 200), (1200, 100), (4, 1), (100, 10)])
def test_warmup_cosine_decay_matches_optax(steps, warmup):
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=warmup,
                                              decay_steps=max(steps, warmup + 1))
    got = warmup_cosine_decay(1e-3, warmup, max(steps, warmup + 1))
    counts = np.arange(steps + 3)
    np.testing.assert_allclose([got(int(c)) for c in counts],
                               np.asarray(jax.vmap(want)(jnp.asarray(counts))),
                               rtol=1e-6, atol=2e-10)  # two f32 ulps of the peak
    assert got(0) == 0.0


@pytest.mark.parametrize("which", ["recognizer", "detector"])
def test_initialisation_follows_flax(which):
    """Every variable has the Flax initialiser's law: lecun_normal kernels
    (std, truncation), zero biases, ``normal(0.02)`` positions, unit norms,
    zero means and unit variances."""
    if which == "recognizer":
        net = ocr._init_recognizer(0, 256, torch.device("cpu"))
        init = _jax_init(JRec(), (1, 32, 256, 1))
    else:
        net = ocr._init_detector(0, torch.device("cpu"))
        init = _jax_init(JDet(), (1, 64, 64, 1))
    assert all(p.dtype == torch.float32 for p in net.parameters())
    params, stats = export_flax_variables(net)
    got, want = _flat({"params": params, "batch_stats": stats}), _flat(_np_tree(init))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if key.endswith(("bias", "mean")) or key.endswith(("scale", "var")):
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        if w.size < 2000:
            continue  # too few draws for a law
        # Kernels and positions: std within 6% and the same largest |w|
        # bound (a normal truncated at 2 std for lecun_normal).
        np.testing.assert_allclose(g.std(), w.std(), rtol=6e-2, err_msg=key)
        if "pos_embedding" in key:
            np.testing.assert_allclose(g.std(), 0.02, rtol=5e-2)
        else:
            assert np.abs(g).max() <= np.abs(w).max() * 1.05 + 1e-6, key


# ---------------------------------------------------------------------------
# The npz format, both ways
# ---------------------------------------------------------------------------


def test_npz_written_by_the_port_loads_into_jax(tmp_path):
    net = ocr._init_recognizer(3, 64, torch.device("cpu"))
    x = torch.rand(2, 32, 64, 1, generator=torch.Generator().manual_seed(0))
    net(x, train=True)  # move the running statistics off their start
    variables = ocr._variables(net)
    path = tmp_path / "rec.npz"
    save_variables_npz(variables, path)
    with np.load(path) as data:
        assert all(data[k].dtype == (np.float16 if k.startswith("params/") else np.float32)
                   for k in data.files)
    jvars = jocr.load_variables_npz(path)
    want = np.asarray(jax.jit(functools.partial(JRec().apply, train=False))(
        jvars, jnp.asarray(x.numpy())))
    port = TextRecognitionNet(patch_width=64).eval()
    load_flax_variables(port, *(lambda v: (v["params"], v["batch_stats"]))(
        ocr.load_variables_npz(path)))
    with torch.no_grad():
        got = port(x).numpy()
    gap = np.abs(got - want) / np.abs(want).max()
    assert np.median(gap) <= 2e-3 and gap.max() <= 2e-2, (np.median(gap), gap.max())


def test_npz_written_by_jax_loads_into_the_port(tmp_path):
    init = _jax_init(JDet(), (1, 64, 64, 1), seed=2)
    path = tmp_path / "det.npz"
    jocr.save_variables_npz(init, path)
    got = ocr.load_variables_npz(path)
    want = jocr.load_variables_npz(path)
    assert _flat(got).keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[k], v)
    net = TextDetectionNet().eval()
    load_flax_variables(net, got["params"], got["batch_stats"])
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 1)).astype(np.float32)
    with torch.no_grad():
        prob = net(torch.from_numpy(x)).numpy()
    want_prob = np.asarray(jax.jit(JDet().apply)(want, jnp.asarray(x)))
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1.5e-2)


# ---------------------------------------------------------------------------
# train_ocr_stack
# ---------------------------------------------------------------------------


def test_train_ocr_stack_writes_what_the_loaders_read(monkeypatch, tmp_path):
    from spine_vision_torch.data.phenikaa import _build_extractor, _load_ocr_variables
    from spine_vision_torch.data.phenikaa import PreprocessConfig

    monkeypatch.setattr(ocr, "train_recognizer", functools.partial(
        ocr.train_recognizer, batch_size=2, chunk=2, eval_samples=4))
    monkeypatch.setattr(ocr, "train_detector", functools.partial(
        ocr.train_detector, batch_size=2, chunk=2, page_hw=(64, 128)))
    monkeypatch.setattr(ocr, "evaluate_recognizer", functools.partial(
        ocr.evaluate_recognizer, n=4))
    monkeypatch.setattr(ocr, "evaluate_recognizer_mpl", functools.partial(
        ocr.evaluate_recognizer_mpl, n=2))
    monkeypatch.setattr(ocr, "evaluate_detector", functools.partial(
        ocr.evaluate_detector, n_pages=2))
    monkeypatch.setattr(ocr, "evaluate_layout_extraction", functools.partial(
        ocr.evaluate_layout_extraction, n_pages=1))
    metrics = ocr.train_ocr_stack(tmp_path, recognizer_steps=2, detector_steps=2, device="cpu")
    assert list(metrics) == [
        "recognizer_cer", "detector_box_recall", "recognizer_cer_degraded",
        "detector_box_recall_degraded", "layout_extraction_rate",
        "recognizer_cer_unseen_renderer", "recognizer_cer_unseen_font",
        "detector_box_recall_unseen_font",
    ]
    assert all(0.0 <= v <= 1.0 or k.startswith("recognizer_cer") for k, v in metrics.items())
    rec, det = tmp_path / "ocr_recognizer.npz", tmp_path / "ocr_detector.npz"
    assert _load_ocr_variables(rec).keys() == {"params", "batch_stats"}
    config = PreprocessConfig(data_path=tmp_path, detection_checkpoint=det,
                              recognition_checkpoint=rec)
    extractor = _build_extractor(config, device="cpu")
    assert isinstance(extractor.extract_from_image(np.full((64, 128), 250, np.uint8)), list)


def test_train_ocr_stack_needs_an_output_dir():
    with pytest.raises(TypeError):
        ocr.train_ocr_stack()  # noqa
    with pytest.raises(ValueError, match="output_dir"):
        ocr.train_ocr_stack(None, device="cpu")


def test_unseen_renderer_metric_is_left_out_without_matplotlib(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(ocr, "train_recognizer", lambda **kw: ({}, 0.5))
    monkeypatch.setattr(ocr, "train_detector", lambda **kw: ({}, 0.5))
    monkeypatch.setattr(ocr, "evaluate_recognizer", lambda *a, **kw: 0.25)
    monkeypatch.setattr(ocr, "evaluate_detector", lambda *a, **kw: 0.75)
    monkeypatch.setattr(ocr, "evaluate_layout_extraction", lambda *a, **kw: 1.0)

    def no_matplotlib(*a, **kw):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(ocr, "evaluate_recognizer_mpl", no_matplotlib)
    with caplog.at_level("WARNING", logger="spine_vision_torch"):
        metrics = ocr.train_ocr_stack(tmp_path, device="cpu")
    assert "recognizer_cer_unseen_renderer" not in metrics
    assert metrics["recognizer_cer_unseen_font"] == 0.25
    assert "matplotlib" in caplog.text
    assert math.isclose(metrics["recognizer_cer"], 0.5)
