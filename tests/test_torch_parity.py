"""The port's parity stages against the JAX package's, on the CPU.

- ``SeriesCropPipeline`` with a seeded ResNet-18 regressor carried into both
  packages by ``models/convert.py``, at the parity suite's sizes (loc 128²,
  crops 48², slices padded to 192²), in both crop modes, and at the fallback
  centres without a model.
- ``LocalizationTrainer.evaluate`` of both packages on the same carried
  weights and the same test set.
- ``run_parity`` at a tiny size: its record's keys, ``parity_results.json``
  and the held-out studies of the JAX package's draw order.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import freeze, unfreeze

from spine_vision_torch.data import datasets as tds
from spine_vision_torch.data.png import write_png
from spine_vision_torch.infer import pipeline as tpipe
from spine_vision_torch.models.classifier import CoordinateRegressor as TRegressor
from spine_vision_torch.models.convert import load_flax_variables, random_flax_variables
from spine_vision_torch.parallel import data_parallel_mesh
from spine_vision_torch.train.localization import LocalizationConfig as TConfig
from spine_vision_torch.train.localization import LocalizationTrainer as TTrainer
from spine_vision_torch.utils import parity as tparity
from spine_vision_tpu.infer.pipeline import SeriesCropPipeline as JSeriesCrop
from spine_vision_tpu.infer.pipeline import StudyPipelineConfig as JConfig
from spine_vision_tpu.models import CoordinateRegressor as JRegressor
from spine_vision_tpu.train.localization import LocalizationConfig as JConfigLoc
from spine_vision_tpu.train.localization import LocalizationTrainer as JTrainer
from spine_vision_tpu.utils import parity as jparity

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: a parallel test run (pytest-xdist) shares the
    CPU between its workers, where torch's oversubscribed thread pool runs
    these small ResNet-18 steps several times slower than one thread does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
CROP_CFG = {"loc_image_size": tparity.LOC_SIZE, "crop_size": tparity.CROP_SIZE,
            "crop_delta_mm": tparity.CROP_DELTA_MM, "padded_hw": tparity.SLICE_HW}


@pytest.fixture(scope="module")
def regressor():
    """A seeded ResNet-18 regressor in both packages (f32): (port, JAX
    module, JAX variables)."""
    port = TRegressor("resnet18", dtype=torch.float32, device="cpu")
    params, stats = random_flax_variables(port, 11)
    load_flax_variables(port, params, stats)
    return port.eval(), JRegressor(backbone_name="resnet18", dtype=jnp.float32), \
        {"params": params, "batch_stats": stats}


def _slices(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [tparity._render_slice(rng, rng.integers(1, 6, 5), rng.integers(0, 2, 5))[0]
            for _ in range(n)]


@pytest.mark.parametrize("mode", ["horizontal", "rotated"])
@pytest.mark.parametrize("with_model", [True, False])
def test_series_crop_pipeline_matches_jax(regressor, mode, with_model):
    port, jmodel, jvars = regressor
    slices = _slices(3, 5)  # bucketed to 4 rows, the last a dummy
    spacings = [(1.0, 1.0), (0.8, 1.2), (1.1, 0.9)]
    got = tpipe.SeriesCropPipeline(
        port if with_model else None, tpipe.StudyPipelineConfig(crop_mode=mode, **CROP_CFG),
        device="cpu",
    ).run(slices, spacings)
    want = JSeriesCrop(
        jmodel if with_model else None, jvars if with_model else None,
        config=JConfig(crop_mode=mode, **CROP_CFG),
    ).run(slices, spacings)
    coords, angles, crops = got
    assert coords.shape == (3, 5, 2) and angles.shape == (3, 5) and crops.shape == (3, 5, 48, 48)
    # f32 ResNet-18 forwards in two libraries: coordinates within 1e-4 (of
    # a unit square), angles within 1e-2 degrees.
    np.testing.assert_allclose(coords, want[0], atol=1e-4 if with_model else 0)
    np.testing.assert_allclose(angles, want[1], atol=1e-2)
    diff = np.abs(crops.astype(int) - np.asarray(want[2]).astype(int))
    # Stated: <= 1 uint8 level on at most 1% of the crop pixels.
    assert crops.dtype == np.uint8 and diff.max() <= 1 and np.mean(diff > 0) <= 0.01
    if not with_model:
        np.testing.assert_array_equal(coords, np.broadcast_to(tpipe.DEFAULT_IVD_CENTERS_XY,
                                                              coords.shape))


def test_fallback_centers_for_other_level_counts():
    np.testing.assert_array_equal(tpipe._fallback_centers(5), tpipe.DEFAULT_IVD_CENTERS_XY)
    got = tpipe._fallback_centers(3)
    np.testing.assert_allclose(got, [[0.5, 0.25], [0.5, 0.45], [0.5, 0.65]], atol=1e-7)


def test_series_crop_pipeline_mesh_names_the_roadmap(regressor):
    """``SeriesCropPipeline(mesh=...)`` over two CPU entries (3 slices
    bucketed to 4, 2 a device) crops as ``mesh=None`` does, with the model
    and at the fallback centres."""
    cfg = tpipe.StudyPipelineConfig(crop_mode="rotated", **CROP_CFG)
    slices, spacings = _slices(3, 6), [(1.0, 1.0), (0.8, 1.2), (1.1, 0.9)]
    for model in (regressor[0], None):
        got = tpipe.SeriesCropPipeline(model, cfg, mesh=data_parallel_mesh(["cpu", "cpu"])).run(
            slices, spacings)
        want = tpipe.SeriesCropPipeline(model, cfg, device="cpu").run(slices, spacings)
        # Two batches of 2 against one of 4, the same rows in convolutions
        # of another batch size: measured coords within 6e-8 (one f32 ulp),
        # angles within 1.6e-5 degrees, crops equal.
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], atol=1e-4)
        np.testing.assert_array_equal(got[2], want[2])


def _jax_with_weights(trainer, variables) -> None:
    """Put the carried tree into a JAX trainer's replicated state."""
    def put(current, new):
        return jax.tree_util.tree_map(
            lambda c, n: jax.device_put(jnp.asarray(n, c.dtype), c.sharding), current, new)

    state = trainer.state
    trainer.state = state.replace(
        params=freeze(put(unfreeze(state.params), variables["params"])),
        batch_stats=freeze(put(unfreeze(state.batch_stats), variables["batch_stats"])),
    )


def test_localization_evaluate_matches_jax(regressor, tmp_path):
    port, _, jvars = regressor
    store = tparity._build_loc_dataset(tmp_path / "loc", np.random.default_rng(2), 40)

    def split(name):
        return tds.LocalizationDataset(tmp_path / "loc", split=name, val_ratio=0.2,
                                       test_ratio=0.25, image_size=(64, 64), augment=False,
                                       seed=2, image_store=store)

    train, val, test = split("train"), split("val"), split("test")
    assert len(test) == 10  # batches of 8, the last ragged
    common = {"backbone": "resnet18", "pretrained": False, "image_size": (64, 64),
              "batch_size": 8, "mixed_precision": False, "num_workers": 0, "seed": 2}
    tt = TTrainer(TConfig(output_path=tmp_path / "t", **common), model=port, train_dataset=train,
                  val_dataset=val, device="cpu")
    jt = JTrainer(JConfigLoc(output_path=tmp_path / "j", visualize_predictions=False, **common),
                  train_dataset=train, val_dataset=val)
    _jax_with_weights(jt, jvars)
    got, want = tt.evaluate(test), jt.evaluate(test)
    assert sorted(got) == sorted(want) and "med" in got and "pck@0.10" in got
    for key in want:
        # f32 forwards of one ResNet-18 in two libraries: 1e-5 of a unit
        # square in every distance statistic (PCK counts agree exactly).
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)
    # evaluate() reads the test split of config.data_path: the store's
    # arrays written as PNGs decode to the same images, so the same metrics.
    for key, image in store.items():
        (tmp_path / "loc" / key).parent.mkdir(parents=True, exist_ok=True)
        write_png(tmp_path / "loc" / key, image)
    tt.config.data_path = tmp_path / "loc"
    from_disk = tds.LocalizationDataset(tmp_path / "loc", split="test", val_ratio=0.2,
                                        image_size=(64, 64), augment=False, seed=2,
                                        image_store=store)
    assert len(from_disk) > 0
    np.testing.assert_equal(tt.evaluate(), tt.evaluate(from_disk))
    empty = tds.LocalizationDataset(tmp_path / "loc", split="test", test_ratio=0.0,
                                    image_store=store)
    assert len(empty) == 0 and tt.evaluate(empty) == {}


TINY = {"loc_epochs": 1, "cls_epochs": 1, "n_loc_images": 24, "n_cls_patients": 8,
        "n_heldout_studies": 2}


def _jax_heldout(seed: int, tmp_path: Path) -> list[tuple[np.ndarray, np.ndarray]]:
    """The held-out (T1, T2) slices of the JAX package's draw order: its
    loc and cls builders first, then its held-out loop."""
    rng = np.random.default_rng(seed)
    jparity._write_loc_dataset(tmp_path / "jloc", rng, TINY["n_loc_images"])
    pipes = {m: JSeriesCrop(None, None, config=JConfig(crop_mode=m, **CROP_CFG))
             for m in ("horizontal", "rotated")}
    jparity._write_cls_dataset(tmp_path / "jcls", rng, TINY["n_cls_patients"], pipes)
    out = []
    for _ in range(TINY["n_heldout_studies"]):
        grades, herns = rng.integers(1, 6, size=5), rng.integers(0, 2, size=5)
        t2, _ = jparity._render_slice(rng, grades, herns)
        t1, _ = jparity._render_slice(rng, grades, herns)
        out.append((t1, t2))
    return out


def test_tiny_run_parity_record_and_heldout_studies(tmp_path, monkeypatch):
    rendered = []
    render = tparity._render_heldout

    def spy(rng, n):
        out = render(rng, n)
        rendered.append(out[0])
        return out

    monkeypatch.setattr(tparity, "_render_heldout", spy)
    record = tparity.run_parity(tmp_path / "port", seed=4, device="cpu", **TINY)
    reference = json.loads((ROOT / "PARITY_RESULTS.json").read_text())
    assert list(record) == list(reference)
    written = json.loads((tmp_path / "port" / "parity_results.json").read_text())
    assert list(written) == list(record)
    for key, value in record.items():
        same = (isinstance(value, float) and math.isnan(value) and math.isnan(written[key])) \
            or written[key] == value
        assert same, key
    for key in ("loc_pass", "cls_pass", "e2e_pass", "e2e_auc_defined", "e2e_rotated_pass",
                "e2e_rotated_materially_differs", "all_pass"):
        assert isinstance(record[key], bool), key
    assert record["e2e_crop_mode_comparisons"] == 5 * TINY["n_heldout_studies"]

    (studies,) = rendered
    want = _jax_heldout(4, tmp_path)
    assert [s.study_id for s in studies] == ["parity0", "parity1"]
    for study, (t1, t2) in zip(studies, want):
        np.testing.assert_array_equal(study.t1_slice, t1)
        np.testing.assert_array_equal(study.t2_slice, t2)
        assert study.t1_spacing == study.t2_spacing == (1.0, 1.0)


def test_run_parity_takes_the_ported_resnet_only(tmp_path):
    with pytest.raises(NotImplementedError, match="norm_impl='flax'"):
        tparity.run_parity(tmp_path, norm_impl="flax", device="cpu", **TINY)
    with pytest.raises(ValueError, match="n_heldout_studies"):
        tparity.run_parity(tmp_path, device="cpu", **{**TINY, "n_heldout_studies": 0})


@pytest.mark.parametrize("flax_shape, port_shape", [
    ((3, 3, 64, 256), (256, 64, 3, 3)),  # a ResNet-18 conv: fan_in 576
    ((512, 256), (256, 512)),  # a Dense head: fan_in 512
])
def test_initialisation_draws_flax_lecun_normal(flax_shape, port_shape):
    """The port's own initialisation has Flax's ``lecun_normal`` law (a normal
    truncated at two of its deviations, variance 1 / fan_in), the law the
    parity suite's JAX models start from."""
    from flax.linen import initializers

    from spine_vision_torch.models.layers import _lecun_normal

    fan_in = int(np.prod(flax_shape[:-1]))
    got = _lecun_normal(port_shape, fan_in, torch.Generator().manual_seed(0)).numpy().ravel()
    want = np.asarray(initializers.lecun_normal()(jax.random.PRNGKey(0), flax_shape)).ravel()
    bound = 2.0 / (math.sqrt(fan_in) * 0.87962566103423978)
    assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(want).max() <= bound * (1 + 1e-6)
    # 131K-147K draws each: the std and the quartiles of |w| within 2%.
    np.testing.assert_allclose(got.std(), 1 / math.sqrt(fan_in), rtol=2e-2)
    np.testing.assert_allclose(np.percentile(np.abs(got), [25, 50, 75, 99]),
                               np.percentile(np.abs(want), [25, 50, 75, 99]), rtol=2e-2)
