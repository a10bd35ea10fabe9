"""IVD level constants, a copy of ``spine_vision_tpu/data/levels.py``."""

LEVEL_TO_IDX: dict[str, int] = {
    "L1/L2": 0,
    "L2/L3": 1,
    "L3/L4": 2,
    "L4/L5": 3,
    "L5/S1": 4,
}
IDX_TO_LEVEL: dict[int, str] = {v: k for k, v in LEVEL_TO_IDX.items()}

LEVEL_NAMES: tuple[str, ...] = tuple(LEVEL_TO_IDX.keys())
NUM_LEVELS: int = len(LEVEL_NAMES)

SERIES_TYPE_TO_IDX: dict[str, int] = {
    "sag_t1": 0,
    "sag_t2": 1,
    "ct": 2,
}

__all__ = [
    "LEVEL_TO_IDX",
    "IDX_TO_LEVEL",
    "LEVEL_NAMES",
    "NUM_LEVELS",
    "SERIES_TYPE_TO_IDX",
]
