"""The port's packed sample cache (``spine_vision_torch/data/cache.py``).

The counterparts of ``tests/test_cache.py``'s cases on the port's cache and
loader (exact round trip, reuse, staleness, loader integration, the
``get_batch`` fast path), then the cross-package cases: a cache built by
either package is reused, not rebuilt, by the other with the same token, for
synthetic samples and for both packages' datasets over one PNG directory,
and gives the same batches.
"""

import json

import numpy as np
import pytest

from spine_vision_torch.data.cache import PackedDataset, build_packed_cache, packed_view
from spine_vision_torch.data.loader import DataLoader


class _SynthClsDataset:
    """Shape-compatible with ClassificationDataset samples (uint8 image,
    nested targets, metadata strings)."""

    def __init__(self, n=12, size=16):
        self.n = n
        self.size = size
        self.loads = 0  # decode-count probe

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        self.loads += 1
        rng = np.random.default_rng(idx)
        return {
            "image": rng.integers(0, 255, (self.size, self.size, 3), np.uint8),
            "targets": {
                "pfirrmann": np.int32(idx % 5),
                "herniation": np.asarray([float(idx % 2)], np.float32),
            },
            "level_idx": idx % 5,
            "metadata": {"source": "synth", "patient_id": f"p{idx:03d}"},
        }


def _assert_sample_equal(got, want):
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["image"].dtype == np.uint8
    np.testing.assert_array_equal(
        got["targets"]["pfirrmann"], want["targets"]["pfirrmann"]
    )
    np.testing.assert_array_equal(
        got["targets"]["herniation"], want["targets"]["herniation"]
    )
    assert got["targets"]["herniation"].dtype == np.float32
    assert int(got["level_idx"]) == int(want["level_idx"])
    assert got["metadata"] == want["metadata"]


def test_roundtrip_exact(tmp_path):
    ds = _SynthClsDataset()
    build_packed_cache(ds, tmp_path / "c", num_workers=2)
    packed = PackedDataset(tmp_path / "c")
    assert len(packed) == len(ds)
    for idx in range(len(ds)):
        _assert_sample_equal(packed[idx], ds[idx])


def test_packed_view_reuses_and_rebuilds(tmp_path):
    ds = _SynthClsDataset()
    packed_view(ds, tmp_path / "c", num_workers=2, fingerprint_token="a")
    builds_after_first = ds.loads
    assert builds_after_first >= len(ds)

    # Reuse: only the fingerprint probes (first + last + <=6 seeded
    # interior rows) are decoded, never the whole dataset.
    ds2 = _SynthClsDataset()
    packed = packed_view(ds2, tmp_path / "c", num_workers=2, fingerprint_token="a")
    assert ds2.loads <= 8 < len(ds2)
    _assert_sample_equal(packed[3], ds2[3])

    # Token change -> stale -> rebuild.
    ds3 = _SynthClsDataset()
    packed_view(ds3, tmp_path / "c", num_workers=2, fingerprint_token="b")
    assert ds3.loads >= len(ds3)

    # Different length -> stale -> rebuild.
    ds4 = _SynthClsDataset(n=8)
    packed4 = packed_view(ds4, tmp_path / "c", num_workers=2, fingerprint_token="b")
    assert len(packed4) == 8


def test_interior_edit_triggers_rebuild(tmp_path):
    """An in-place edit of a probed interior row (count/shapes unchanged)
    must change the fingerprint and rebuild."""
    ds = _SynthClsDataset()
    packed_view(ds, tmp_path / "c", num_workers=2, fingerprint_token="a")

    # Same seeded probe-row selection as data/cache.py::_fingerprint.
    n = len(ds)
    probe = np.random.default_rng(n).choice(n - 2, size=min(6, n - 2), replace=False) + 1
    target = int(sorted(int(i) for i in probe)[0])

    class Edited(_SynthClsDataset):
        def __getitem__(self, idx):
            s = super().__getitem__(idx)
            if idx == target:
                s["targets"]["pfirrmann"] = np.int32((int(s["targets"]["pfirrmann"]) + 1) % 5)
            return s

    ds2 = Edited()
    packed = packed_view(ds2, tmp_path / "c", num_workers=2, fingerprint_token="a")
    assert ds2.loads >= len(ds2)  # rebuilt, not served stale
    _assert_sample_equal(packed[target], ds2[target])


def test_corrupt_index_triggers_rebuild(tmp_path):
    ds = _SynthClsDataset()
    packed_view(ds, tmp_path / "c", num_workers=2)
    (tmp_path / "c" / "index.json").write_text("{not json")
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    _assert_sample_equal(packed[0], ds[0])


def test_shape_drift_raises(tmp_path):
    class Drift(_SynthClsDataset):
        def __getitem__(self, idx):
            s = super().__getitem__(idx)
            if idx == 5:
                s["image"] = s["image"][:4]
            return s

    with pytest.raises(ValueError, match="field 'image'"):
        build_packed_cache(Drift(), tmp_path / "c", num_workers=1)


def test_loader_over_packed_dataset(tmp_path):
    ds = _SynthClsDataset(n=16)
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    loader = DataLoader(packed, batch_size=4, shuffle=False, seed=0, num_workers=2)
    batches = list(loader)
    assert len(batches) == 4
    b0 = batches[0]
    assert b0["image"].shape == (4, 16, 16, 3) and b0["image"].dtype == np.uint8
    assert b0["targets"]["pfirrmann"].shape == (4,)
    assert b0["metadata"]["patient_id"][1] == "p001"
    # Index metadata records field specs for tooling.
    index = json.loads((tmp_path / "c" / "index.json").read_text())
    assert index["fields"]["image"]["dtype"] == "uint8"


class _MixedMetaDataset(_SynthClsDataset):
    """metadata mixes array-able (int) and string members — the int must
    survive the cache round-trip (regression: the merge used to overwrite
    the whole metadata subtree with the non-array remainder)."""

    def __getitem__(self, idx):
        sample = super().__getitem__(idx)
        sample["metadata"]["ivd"] = idx % 5 + 1
        return sample


def test_mixed_metadata_subtree_roundtrips(tmp_path):
    ds = _MixedMetaDataset()
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    got = packed[7]
    assert int(got["metadata"]["ivd"]) == 7 % 5 + 1
    assert got["metadata"]["patient_id"] == "p007"
    assert got["metadata"]["source"] == "synth"


def test_content_change_triggers_rebuild(tmp_path):
    """Same count, same shapes, different pixel/label content -> the
    content-probe fingerprint must rebuild (labels edited in place)."""

    class _Shifted(_SynthClsDataset):
        def __getitem__(self, idx):
            sample = super().__getitem__(idx)
            sample["image"] = sample["image"] // 2  # same shape/dtype
            return sample

    ds = _SynthClsDataset()
    packed_view(ds, tmp_path / "c", num_workers=2)
    shifted = _Shifted()
    packed = packed_view(shifted, tmp_path / "c", num_workers=2)
    assert shifted.loads >= len(shifted)  # rebuilt, not reused
    np.testing.assert_array_equal(packed[3]["image"], shifted[3]["image"])


def test_metadata_mutation_does_not_persist(tmp_path):
    ds = _SynthClsDataset()
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    sample = packed[2]
    sample["metadata"]["patient_id"] = "MUTATED"
    assert packed[2]["metadata"]["patient_id"] == "p002"


def test_extra_field_in_later_sample_raises(tmp_path):
    class _Drifting(_SynthClsDataset):
        def __getitem__(self, idx):
            sample = super().__getitem__(idx)
            if idx == 5:
                sample["surprise"] = np.zeros(3, np.float32)
            return sample

    with pytest.raises(ValueError, match="differ from sample 0"):
        build_packed_cache(_Drifting(), tmp_path / "c", num_workers=2)


# ---------------------------------------------------------------------------
# Vectorized batch path (get_batch)
# ---------------------------------------------------------------------------


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert set(g) == set(w)
            for sub in w:
                if isinstance(w[sub], np.ndarray):
                    np.testing.assert_array_equal(g[sub], w[sub])
                    assert g[sub].dtype == w[sub].dtype
                else:
                    assert g[sub] == w[sub]
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        else:
            assert g == w


def test_get_batch_mirrors_default_collate(tmp_path):
    from spine_vision_torch.data.loader import default_collate

    ds = _MixedMetaDataset(n=10)  # mixed array/string metadata subtree
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    idx = [7, 0, 3, 3]  # out of order + a weighted-sampling duplicate
    got = packed.get_batch(idx)
    want = default_collate([packed[i] for i in idx])
    _assert_batch_equal(got, want)


def test_get_batch_metadata_isolated_per_row(tmp_path):
    """Duplicate rows and repeated epochs must never share (or persist)
    mutable metadata — the __getitem__ deepcopy contract."""
    ds = _SynthClsDataset(n=6)
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    batch = packed.get_batch([2, 2])
    batch["metadata"]["patient_id"][0] = "MUTATED"
    assert batch["metadata"]["patient_id"][1] == "p002"
    assert packed.get_batch([2])["metadata"]["patient_id"][0] == "p002"


def test_get_batch_declines_deep_nesting(tmp_path):
    """Arrays nested two dict levels deep collate as lists-of-dicts, which
    a field-wise gather can't mirror -> get_batch must return None and the
    loader must fall back to the per-sample path."""

    class _Deep(_SynthClsDataset):
        def __getitem__(self, idx):
            sample = super().__getitem__(idx)
            sample["aux"] = {"inner": {"deep": np.float32(idx)}}
            return sample

    ds = _Deep(n=8)
    packed = packed_view(ds, tmp_path / "deep", num_workers=2)
    assert packed.get_batch([0, 1]) is None
    loader = DataLoader(packed, batch_size=4, shuffle=False, seed=0, num_workers=2)
    batches = list(loader)
    assert len(batches) == 2
    # Fallback batch matches collate-of-__getitem__ exactly.
    assert batches[0]["aux"]["inner"][1]["deep"] == np.float32(1)
    np.testing.assert_array_equal(
        batches[0]["image"][2], packed[2]["image"]
    )


def test_loader_uses_fast_path_and_matches_slow_path(tmp_path):
    ds = _SynthClsDataset(n=16)
    packed = packed_view(ds, tmp_path / "c", num_workers=2)
    fast = list(DataLoader(packed, batch_size=4, shuffle=True, seed=3, num_workers=2))

    class _NoFast:
        """Same data, get_batch hidden -> forces the per-sample path."""

        def __init__(self, inner):
            self._inner = inner

        def __len__(self):
            return len(self._inner)

        def __getitem__(self, idx):
            return self._inner[idx]

    slow = list(
        DataLoader(_NoFast(packed), batch_size=4, shuffle=True, seed=3, num_workers=2)
    )
    assert len(fast) == len(slow)
    for f, s in zip(fast, slow):
        _assert_batch_equal(f, s)


def test_custom_collate_bypasses_fast_path(tmp_path):
    """A custom collate_fn expects per-sample dicts; get_batch must not
    preempt it."""
    ds = _SynthClsDataset(n=8)
    packed = packed_view(ds, tmp_path / "c", num_workers=2)

    def images_only(samples):
        return {"image": np.stack([s["image"] for s in samples])[..., 0]}

    loader = DataLoader(
        packed, batch_size=4, shuffle=False, seed=0, num_workers=2,
        collate_fn=images_only,
    )
    b0 = next(iter(loader))
    assert set(b0) == {"image"} and b0["image"].shape == (4, 16, 16)


# ---------------------------------------------------------------------------
# Across the packages: one on-disk format, one fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_cache_built_by_either_package_is_reused_by_the_other(tmp_path, builder):
    from spine_vision_tpu.data import cache as jcache

    build, reuse = (jcache, None) if builder == "jax" else (None, jcache)
    first = _MixedMetaDataset(n=10)
    (build.packed_view if build else packed_view)(first, tmp_path / "c", num_workers=2,
                                                  fingerprint_token="tok")
    assert first.loads >= len(first)
    stamp = (tmp_path / "c" / "index.json").stat().st_mtime_ns
    second = _MixedMetaDataset(n=10)
    view = (reuse.packed_view if reuse else packed_view)(second, tmp_path / "c",
                                                         num_workers=2, fingerprint_token="tok")
    assert second.loads <= 8 < len(second)  # the fingerprint's probes only
    assert (tmp_path / "c" / "index.json").stat().st_mtime_ns == stamp
    other = (jcache.PackedDataset if builder == "port" else PackedDataset)(tmp_path / "c")
    idx = [7, 0, 3, 3]
    _assert_batch_equal(view.get_batch(idx), other.get_batch(idx))
    for i in range(len(first)):
        _assert_sample_equal(view[i], first[i])


def _png_dirs(root):
    """One localization and one classification directory of gray PNGs,
    written with PIL as the JAX builders write them."""
    from PIL import Image

    rng = np.random.default_rng(11)
    levels = ["L1/L2", "L2/L3", "L3/L4", "L4/L5", "L5/S1"]
    loc, cls = root / "loc", root / "cls"
    for d in (loc, cls):
        (d / "images").mkdir(parents=True)
    rows = ["image_path,level,relative_x,relative_y,series_type,source"]
    for i in range(12):
        Image.fromarray(rng.integers(0, 256, (40, 36), dtype=np.uint8)).save(
            loc / f"images/{i}.png")
        for level in levels[: 3 + i % 3]:
            x, y = rng.uniform(0.1, 0.9, 2)
            rows.append(f"images/{i}.png,{level},{x},{y},sag_t{1 + i % 2},src{i % 2}")
    (loc / "annotations.csv").write_text("\n".join(rows) + "\n")
    rows = ["image_path,patient_id,ivd_level,series_type,source,pfirrmann_grade,"
            "disc_herniation,disc_narrowing,disc_bulging,spondylolisthesis,modic,"
            "up_endplate,low_endplate"]
    for p in range(8):
        for level in range(1, 6):
            labels = [rng.integers(1, 6), *rng.integers(0, 2, 4), rng.integers(0, 4),
                      *rng.integers(0, 2, 2)]
            for series in ("sag_t1", "sag_t2"):
                name = f"images/s_p{p}_{series}_L{level}.png"
                Image.fromarray(rng.integers(0, 256, (24, 24), dtype=np.uint8)).save(cls / name)
                rows.append(",".join(map(str, [name, f"p{p}", level, series, "s", *labels])))
    (cls / "annotations.csv").write_text("\n".join(rows) + "\n")
    return loc, cls


def test_datasets_of_both_packages_share_a_cache(tmp_path):
    """The JAX datasets (cv2) build; the port's (PngStore) over the same
    directory reuse: their samples, metadata and fingerprints agree. The
    trainers' token is ``f"{type(ds).__name__}:{seed}:train"``."""
    from spine_vision_torch.data import datasets as tds
    from spine_vision_torch.data.loader import collate_classification, collate_localization
    from spine_vision_tpu.data import cache as jcache
    from spine_vision_tpu.data import datasets as jds

    loc, cls = _png_dirs(tmp_path)
    pairs = [
        (jds.LocalizationDataset(loc, split="train", image_size=(32, 32)),
         tds.LocalizationDataset(loc, split="train", image_size=(32, 32)), collate_localization),
        (jds.ClassificationDataset(cls, split="train", output_size=(20, 20)),
         tds.ClassificationDataset(cls, split="train", output_size=(20, 20)),
         collate_classification),
    ]
    for jset, tset, collate in pairs:
        name = type(tset).__name__
        assert name == type(jset).__name__ and len(tset) == len(jset) > 2
        cache_dir = tmp_path / "cache" / name
        jview = jcache.packed_view(jset, cache_dir, num_workers=2,
                                   fingerprint_token=f"{name}:0:train")
        stamp = (cache_dir / "image.npy").stat().st_mtime_ns
        tview = packed_view(tset, cache_dir, num_workers=2, fingerprint_token=f"{name}:0:train")
        assert (cache_dir / "image.npy").stat().st_mtime_ns == stamp, f"{name} rebuilt"
        idx = list(range(len(tset)))
        got, want = collate([tview[i] for i in idx]), collate([tset[i] for i in idx])
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["image"], collate([jview[i] for i in idx])["image"])
        assert got["metadata"] == want["metadata"]
