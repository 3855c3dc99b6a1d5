"""CSV golden-file helpers (a copy of ``whisper_rs_tpu/utils/csvio.py``)."""

from __future__ import annotations

import numpy as np


def read_csv_2d(path) -> np.ndarray:
    """[rows, cols] float array from a comma-separated file."""
    return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)


def write_csv_2d(path, array: np.ndarray) -> None:
    np.savetxt(path, np.asarray(array), delimiter=",")
