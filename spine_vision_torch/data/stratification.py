"""Patient-level stratified splitting.

A numpy copy of ``spine_vision_tpu/data/stratification.py``:

- the patient labels: single-label = the max value across a patient's IVD
  levels; multilabel = a binary indicator matrix (pfirrmann one-hot,
  1-indexed; modic one-hot; the binary tasks as "any level");
- multilabel splits by iterative stratification (Sechidis et al. 2011);
- single-label splits by :func:`stratified_shuffle_split`, which gives
  sklearn's ``StratifiedShuffleSplit(n_splits=1, test_size, random_state)``
  train and test indices for the same labels and seed (sklearn is not a
  dependency of the port), with the plain-permutation fallback when a class
  is too small to stratify.
"""

from __future__ import annotations

import math

import numpy as np

from spine_vision_torch.core.tasks import get_task

# task name -> record key
_LABEL_TO_RECORD_KEY = {
    "pfirrmann": "pfirrmann",
    "modic": "modic",
    "herniation": "herniation",
    "bulging": "bulging",
    "upper_endplate": "upper_endplate",
    "lower_endplate": "lower_endplate",
    "spondy": "spondylolisthesis",
    "narrowing": "narrowing",
}


def _approximate_mode(
    class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState
) -> np.ndarray:
    """sklearn's ``utils.extmath._approximate_mode``: per-class draws that
    sum to ``n_draws``, the remainders' ties broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_shuffle_split(
    labels: np.ndarray, test_size: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """One stratified shuffle split of ``labels`` ``[n]`` into (train, test)
    indices: sklearn's ``StratifiedShuffleSplit(n_splits=1,
    test_size=test_size, random_state=seed)``, its draws in its order.

    Raises ``ValueError`` where sklearn does: a fraction outside (0, 1), a
    class with one member, or a side smaller than the number of classes.
    """
    labels = np.asarray(labels)
    n = labels.shape[0]
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the train set is empty")
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(
            f"The least populated classes have only 1 member: {classes[class_counts < 2].tolist()}"
        )
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must reach the {len(classes)} classes"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list[int] = []
    test: list[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def get_patient_single_label(patients: list[str], records: list[dict], label: str) -> np.ndarray:
    """Stratification label per patient: max across their IVD levels."""
    record_key = _LABEL_TO_RECORD_KEY.get(label, label)
    patient_set = set(patients)
    patient_to_labels: dict[str, list[int]] = {p: [] for p in patients}
    for record in records:
        pk = record["patient_key"]
        if pk in patient_set:
            patient_to_labels[pk].append(record[record_key])
    return np.asarray([max(patient_to_labels.get(p) or [0]) for p in patients])


def get_patient_multilabel_matrix(
    patients: list[str], records: list[dict], target_labels: list[str]
) -> np.ndarray:
    """``[n_patients, n_columns]`` binary indicator matrix for stratification."""
    patient_set = set(patients)
    patient_idx = {p: i for i, p in enumerate(patients)}

    columns: list[tuple[str, int | None]] = []
    for label in target_labels:
        task = get_task(label)
        if task.is_multiclass:
            columns.extend((label, c) for c in range(task.num_classes))
        else:
            columns.append((label, None))

    matrix = np.zeros((len(patients), len(columns)), dtype=np.float32)
    for record in records:
        pk = record["patient_key"]
        if pk not in patient_set:
            continue
        row = patient_idx[pk]
        for col, (label, cls_idx) in enumerate(columns):
            value = record[_LABEL_TO_RECORD_KEY.get(label, label)]
            if cls_idx is not None:
                if label == "pfirrmann":
                    if value == cls_idx + 1:  # pfirrmann is 1-indexed
                        matrix[row, col] = 1.0
                elif value == cls_idx:
                    matrix[row, col] = 1.0
            elif value > 0:
                matrix[row, col] = 1.0
    return matrix


def iterative_multilabel_split(
    labels: np.ndarray, test_fraction: float, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """One iterative-stratification split of ``labels`` ``[n, m]`` (binary)
    into (train, test) indices.

    Greedy: take the rarest label among the remaining samples and give each
    sample carrying it to the fold that wants that label most (ties: the
    fold with the most room left, then a seeded draw).
    """
    rng = np.random.RandomState(seed)
    n = labels.shape[0]
    ratios = np.asarray([1.0 - test_fraction, test_fraction])

    desired_samples = ratios * n
    desired_labels = ratios[None, :] * labels.sum(axis=0)[:, None]  # [m, 2]

    remaining = np.ones(n, dtype=bool)
    fold_of = np.full(n, -1, dtype=np.int64)

    while remaining.any():
        remaining_label_counts = labels[remaining].sum(axis=0)
        active = np.where(remaining_label_counts > 0)[0]
        if active.size == 0:
            # No labels left: distribute by remaining room.
            for i in np.where(remaining)[0]:
                fold = int(np.argmax(desired_samples))
                fold_of[i] = fold
                desired_samples[fold] -= 1
                remaining[i] = False
            break

        label = active[np.argmin(remaining_label_counts[active])]
        sample_ids = np.where(remaining & (labels[:, label] > 0))[0]
        rng.shuffle(sample_ids)
        for i in sample_ids:
            want = desired_labels[label]
            best = np.where(want == want.max())[0]
            if best.size > 1:
                cap = desired_samples[best]
                best = best[np.where(cap == cap.max())[0]]
                fold = int(rng.choice(best))
            else:
                fold = int(best[0])
            fold_of[i] = fold
            desired_samples[fold] -= 1
            desired_labels[labels[i] > 0, fold] -= 1
            remaining[i] = False

    return np.where(fold_of == 0)[0], np.where(fold_of == 1)[0]


def split_patients_single_label(
    patients: list[str],
    records: list[dict],
    target_label: str,
    val_ratio: float,
    test_ratio: float,
    seed: int,
) -> tuple[set[str], set[str], set[str]]:
    """Two-stage single-label stratified split (test first, then val)."""
    patients_arr = np.asarray(patients)
    stratify = get_patient_single_label(patients, records, target_label)

    def _safe_split(arr: np.ndarray, labels: np.ndarray, fraction: float):
        """Stratified, or a plain seeded permutation when a class is too
        small to stratify."""
        try:
            return stratified_shuffle_split(labels, fraction, seed)
        except ValueError:
            indices = np.random.RandomState(seed).permutation(len(arr))
            n_test = max(int(round(len(arr) * fraction)), 1)
            return indices[n_test:], indices[:n_test]

    if test_ratio > 0 and len(patients_arr) > 1:
        train_val_idx, test_idx = _safe_split(patients_arr, stratify, test_ratio)
        test_patients = set(patients_arr[test_idx])
        remaining = patients_arr[train_val_idx]
        remaining_labels = stratify[train_val_idx]
    else:
        test_patients = set()
        remaining = patients_arr
        remaining_labels = stratify

    if val_ratio > 0 and len(remaining) > 1:
        adjusted = val_ratio / (1 - test_ratio)
        train_idx, val_idx = _safe_split(remaining, remaining_labels, adjusted)
        return set(remaining[train_idx]), set(remaining[val_idx]), test_patients
    return set(remaining), set(), test_patients


def split_patients_multilabel(
    patients: list[str],
    records: list[dict],
    target_labels: list[str],
    val_ratio: float,
    test_ratio: float,
    seed: int,
) -> tuple[set[str], set[str], set[str]]:
    """Two-stage multilabel iterative-stratification split."""
    patients_arr = np.asarray(patients)
    matrix = get_patient_multilabel_matrix(patients, records, target_labels)

    if test_ratio > 0 and len(patients_arr) > 1:
        train_val_idx, test_idx = iterative_multilabel_split(matrix, test_ratio, seed)
        test_patients = set(patients_arr[test_idx])
        remaining = patients_arr[train_val_idx]
        remaining_matrix = matrix[train_val_idx]
    else:
        test_patients = set()
        remaining = patients_arr
        remaining_matrix = matrix

    if val_ratio > 0 and len(remaining) > 1:
        adjusted = val_ratio / (1 - test_ratio)
        train_idx, val_idx = iterative_multilabel_split(remaining_matrix, adjusted, seed)
        return set(remaining[train_idx]), set(remaining[val_idx]), test_patients
    return set(remaining), set(), test_patients


def split_patients(
    patients: list[str],
    records: list[dict],
    target_labels: list[str],
    val_ratio: float,
    test_ratio: float,
    seed: int,
) -> tuple[set[str], set[str], set[str]]:
    """Stratified train/val/test patient split (strategy by label count)."""
    if len(target_labels) > 1:
        return split_patients_multilabel(
            patients, records, target_labels, val_ratio, test_ratio, seed
        )
    return split_patients_single_label(
        patients, records, target_labels[0], val_ratio, test_ratio, seed
    )
