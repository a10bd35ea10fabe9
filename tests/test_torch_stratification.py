"""The port's patient-level splits and host resize against the JAX package's.

The same seeded patient tables go through both packages' ``split_patients``
(one label: sklearn's ``StratifiedShuffleSplit`` there, its numpy copy here;
two labels: iterative stratification; a class too small to stratify: the
seeded-permutation fallback), and the numpy ``stratified_shuffle_split``
meets sklearn's indices directly. The host bilinear resize meets
``spine_vision_tpu.native.resize_bilinear_u8`` bit for bit.
"""

import numpy as np
import pytest

from spine_vision_torch.data import datasets as tds
from spine_vision_torch.data import stratification as tstrat
from spine_vision_tpu import native
from spine_vision_tpu.data import stratification as jstrat


def _records(n_patients: int, seed: int, rare: bool = False) -> tuple[list[str], list[dict]]:
    """Five IVD records a patient with seeded labels; ``rare`` gives one
    patient alone a Pfirrmann grade of 5 (a class of one)."""
    rng = np.random.default_rng(seed)
    patients = [f"src_p{i:03d}" for i in range(n_patients)]
    records = []
    for i, pk in enumerate(patients):
        for level in range(5):
            pf = int(rng.integers(1, 5)) if rare else int(rng.integers(1, 6))
            if rare and i == 3 and level == 0:
                pf = 5
            records.append({
                "patient_key": pk, "pfirrmann": pf, "modic": int(rng.integers(0, 4)),
                "herniation": int(rng.random() < 0.3), "bulging": int(rng.random() < 0.5),
                "upper_endplate": 0, "lower_endplate": 0, "spondylolisthesis": 0,
                "narrowing": int(rng.random() < 0.2),
            })
    return patients, records


CASES = {
    "one_label": (["pfirrmann"], 60, False),
    "one_binary_label": (["herniation"], 40, False),
    "two_labels": (["pfirrmann", "herniation"], 60, False),
    "all_labels": (None, 50, False),
    "class_of_one": (["pfirrmann"], 30, True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("ratios", [(0.15, 0.10), (0.2, 0.05), (0.0, 0.1), (0.1, 0.0)])
def test_split_patients_match_jax(case, seed, ratios):
    labels, n, rare = CASES[case]
    labels = labels or ["pfirrmann", "modic", "herniation", "bulging", "narrowing"]
    patients, records = _records(n, seed, rare)
    val, test = ratios
    got = tstrat.split_patients(patients, records, labels, val, test, seed)
    want = jstrat.split_patients(patients, records, labels, val, test, seed)
    assert got == want
    assert set().union(*got) == set(patients) and sum(map(len, got)) == n


def test_class_of_one_takes_the_fallback():
    patients, records = _records(30, 0, rare=True)
    stratify = tstrat.get_patient_single_label(patients, records, "pfirrmann")
    assert (stratify == 5).sum() == 1
    with pytest.raises(ValueError, match="only 1 member"):
        tstrat.stratified_shuffle_split(stratify, 0.1, 0)
    _, _, test = tstrat.split_patients(patients, records, ["pfirrmann"], 0.15, 0.10, 0)
    # The fallback's test share: round(30 * 0.1) patients of a seeded permutation.
    order = np.random.RandomState(0).permutation(30)
    assert test == {patients[i] for i in order[:3]}


def test_patient_label_tables_match_jax():
    patients, records = _records(25, 3)
    labels = ["pfirrmann", "modic", "herniation", "spondy"]
    np.testing.assert_array_equal(
        tstrat.get_patient_multilabel_matrix(patients, records, labels),
        jstrat.get_patient_multilabel_matrix(patients, records, labels),
    )
    for label in labels:
        np.testing.assert_array_equal(
            tstrat.get_patient_single_label(patients, records, label),
            jstrat.get_patient_single_label(patients, records, label),
        )


@pytest.mark.parametrize("n, k, test_size, seed", [
    (40, 3, 0.1, 0), (41, 5, 0.25, 3), (120, 5, 0.15 / 0.9, 42), (17, 2, 0.5, 9), (100, 7, 0.33, 1),
])
def test_stratified_shuffle_split_gives_sklearns_indices(n, k, test_size, seed):
    sk = pytest.importorskip("sklearn.model_selection")
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, size=n)
    labels[:2 * k] = np.repeat(np.arange(k), 2)  # every class at least twice
    train, test = tstrat.stratified_shuffle_split(labels, test_size, seed)
    want_train, want_test = next(
        sk.StratifiedShuffleSplit(n_splits=1, test_size=test_size, random_state=seed)
        .split(np.zeros(n), labels)
    )
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(test, want_test)


@pytest.mark.parametrize("labels, test_size", [
    (np.array([0, 0, 1, 1, 2]), 0.4),  # a class of one
    (np.array([0, 0, 1, 1, 2, 2]), 0.2),  # one test sample for three classes
    (np.array([0, 0, 1, 1]), 1.0),  # not a fraction
])
def test_stratified_shuffle_split_raises_where_sklearn_does(labels, test_size):
    sk = pytest.importorskip("sklearn.model_selection")
    with pytest.raises(ValueError):
        tstrat.stratified_shuffle_split(labels, test_size, 0)
    with pytest.raises(ValueError):
        next(sk.StratifiedShuffleSplit(n_splits=1, test_size=test_size, random_state=0)
             .split(np.zeros(len(labels)), labels))


@pytest.mark.parametrize("shape, out", [
    ((3, 192, 192), (128, 128)),  # parity's localization images
    ((2, 48, 48), (96, 80)),  # up
    ((1, 37, 53), (20, 61)),  # down in one axis, up in the other
    ((45, 31), (45, 31)),  # a plane at its own size
])
def test_resize_matches_the_native_resize_bit_for_bit(shape, out):
    rng = np.random.default_rng(sum(shape))
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    got = tds.resize_bilinear_u8(images, *out)
    want = native.resize_bilinear_u8(images, *out)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
