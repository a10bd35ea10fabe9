"""A few OCR train steps in the port against the JAX package's, on the CPU.

The JAX package's ``train_recognizer`` and ``train_detector`` run with their
chunk renderers replaced by seeded chunks and their nets' ``init`` by the
same (jitted) draws, against the port's fed the same chunks from the same
initial variables: the loss of every step, and the variables after four
AdamW steps (update 0 at lr 0, then the cosine's three).

Bounds of the train-step comparison. The nets compute in bf16 as XLA runs
them (f32 sums, bf16 roundings where the optimized HLO has them), so the
two steps agree to a few bf16 roundings: each step's loss within 2e-3 of
JAX's, relatively. After four updates the parameters differ where Adam
normalises a gradient that is rounding noise (the attention's key bias,
whose gradient is zero in exact arithmetic; conv kernels whose gradient
nearly cancels): such an element can move by the full learning rate the
other way, so every element lies within twice the summed learning rates of
JAX's, the median within 1e-4, and the update as a whole points JAX's way
(the cosine of the two updates at least 0.98; 0.991 and 0.998 measured on
these chunks, rendered lines and pages; on pages of uniform noise, whose
deep gradients nearly cancel, the detector's falls to 0.97). In f32 (every
rounding off in both) the detector's gradients agree within 1e-5 of each
tensor's largest, so the gaps above are bf16's. The running
statistics, moved by activations that differ by those updates, lie within
1e-2 of each buffer's norm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spine_vision_torch.data.phenikaa import synth as ps
from spine_vision_torch.models.convert import load_flax_variables
from spine_vision_torch.models.textdet import TextDetectionNet
from spine_vision_torch.models.textrec import TextRecognitionNet
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _fake_recognition(calls, rng, chunk, batch, width, max_len):
    """Seeded lines (the port's renderer, which draws as the JAX one does),
    the same for both packages whatever Generator they are handed."""
    rng.integers(2**63, size=chunk)  # the Generator moves as the real renderer's
    calls.append(1)
    r = np.random.default_rng(len(calls))
    parts = [ps.recognition_batch(r, batch, width=width, max_len=max_len, degrade="mild",
                                  degrade_p=0.7)[:3] for _ in range(chunk)]
    return tuple(np.stack([p[i] for p in parts]) for i in range(3))


def _fake_detection(calls, rng, chunk, batch, page_hw):
    rng.integers(2**63, size=chunk)
    calls.append(1)
    r = np.random.default_rng(100 + len(calls))
    pages, targets = [], []
    for _ in range(chunk * batch):
        page, boxes, _ = ps.detection_page(r, page_hw, max_lines=3, degrade="mild",
                                           degrade_p=0.7)
        pages.append(page)
        targets.append(ps.detection_target(boxes, page_hw))
    shape = (chunk, batch)
    return (np.stack(pages).reshape(*shape, *page_hw),
            np.stack(targets).reshape(*shape, page_hw[0] // 2, page_hw[1] // 2))


def _run_both(monkeypatch, which):
    """JAX's and the port's train function on the same seeded chunks from
    the same initial variables: (JAX losses, port losses, initial, JAX
    variables, port variables, summed learning rates)."""
    jax_losses, port_losses = [], []
    real_scan = jax.lax.scan

    def scan(f, init, xs, *args, **kwargs):
        carry, ys = real_scan(f, init, xs, *args, **kwargs)
        if hasattr(ys, "ndim") and ys.ndim == 1:  # a train chunk's losses
            jax.debug.callback(lambda y: jax_losses.extend(np.asarray(y).tolist()), ys,
                               ordered=True)
        return carry, ys

    real_update = ocr._update

    def update(*args):
        loss = real_update(*args)
        port_losses.append(float(loss))
        return loss

    monkeypatch.setattr(jax.lax, "scan", scan)
    monkeypatch.setattr(ocr, "_update", update)
    if which == "recognizer":
        kw = dict(steps=4, chunk=2, batch_size=4, width=256, eval_samples=8)
        fake, j_name, p_name = _fake_recognition, "_render_chunk_recognition", "_init_recognizer"
        j_net, shape = JRec, (1, 32, 256, 1)
        make = lambda seed, width, device: TextRecognitionNet(  # noqa: E731
            patch_width=width, param_dtype=torch.float32)
        j_train, p_train, p_render = (jocr.train_recognizer, ocr.train_recognizer,
                                      "_render_chunk_recognition")
    else:
        kw = dict(steps=4, chunk=2, batch_size=2, page_hw=(64, 128))
        fake, j_name, p_name = _fake_detection, "_render_chunk_detection", "_init_detector"
        j_net, shape = JDet, (1, 64, 128, 1)
        make = lambda seed, device: TextDetectionNet(param_dtype=torch.float32)  # noqa: E731
        j_train, p_train, p_render = (jocr.train_detector, ocr.train_detector,
                                      "_render_chunk_detection")
    init = jax.jit(lambda key: j_net().init(key, jnp.zeros(shape), train=True))(
        jax.random.PRNGKey(0))
    monkeypatch.setattr(j_net, "init", lambda self, *a, **kw: init)
    init = jax.tree.map(np.asarray, init)
    monkeypatch.setattr(jocr, j_name, functools.partial(fake, []))
    monkeypatch.setattr(ocr, p_render, functools.partial(fake, []))
    monkeypatch.setattr(ocr, p_name, lambda *a: load_flax_variables(
        make(*a), init["params"], init["batch_stats"]))
    jvars, _ = j_train(**kw)
    pvars, _ = p_train(**kw, device="cpu")
    warmup = 1  # min(.., max(1, 4 // 10))
    schedule = warmup_cosine_decay(1e-3, warmup, 4)
    lr_sum = sum(schedule(k) for k in range(4))
    return jax_losses, port_losses, init, jax.tree.map(np.asarray, jvars), pvars, lr_sum


@pytest.mark.parametrize("which", ["recognizer", "detector"])
def test_train_steps_match_jax(monkeypatch, which):
    jl, pl, init, jv, pv, lr_sum = _run_both(monkeypatch, which)
    assert len(jl) == len(pl) == 4
    np.testing.assert_allclose(pl, jl, rtol=2e-3)
    j, p, i = _flat(jv), _flat(pv), _flat(init)
    assert j.keys() == p.keys()
    keys = [k for k in j if k.startswith("params/")]
    gap = np.concatenate([np.abs(p[k] - j[k]).ravel() for k in keys])
    assert gap.max() <= 2 * lr_sum * 1.01 and np.median(gap) <= 1e-4, (gap.max(), np.median(gap))
    upd_j = np.concatenate([(j[k] - i[k]).ravel() for k in keys])
    upd_p = np.concatenate([(p[k] - i[k]).ravel() for k in keys])
    assert upd_j @ upd_p / (np.linalg.norm(upd_j) * np.linalg.norm(upd_p)) >= 0.98
    for k in j:
        if k.startswith("batch_stats/"):
            assert np.abs(p[k] - j[k]).max() <= 1e-2 * np.linalg.norm(j[k]), k
            assert not np.array_equal(p[k], i[k]), k  # the running statistics moved


