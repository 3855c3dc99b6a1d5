"""The JAX package's ``.npz`` parameter files (counterpart of
``whisper_rs_tpu/models/checkpoint.py::load_params``).

``save_params`` writes the stacked params pytree flattened to one ``.npz``:
each key is the leaf's tree path joined by ``/``
(``decoder/blocks/mlp/fc1/w``), and ``__dims__`` holds the ``ModelDims`` as
JSON bytes.  The port unflattens the file itself and loads the tree through
``state_dict_from_jax``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device import resolve_device
from .params import _dims_from, params_from_jax


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params(path, *, dtype=torch.float32, device=None):
    """A ``.npz`` written by the JAX ``save_params`` -> (``Whisper``,
    ``ModelDims``).  Integer (int8-quantised) leaves raise
    ``NotImplementedError``: the port has no int8 weights yet."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    dims = _dims_from(json.loads(bytes(flat.pop("__dims__")).decode()))
    ints = sorted(k for k, v in flat.items() if np.issubdtype(v.dtype, np.integer))
    if ints:
        raise NotImplementedError(
            f"int8-quantized params ({ints[0]}, ...) wait for the quantisation slice"
        )
    return params_from_jax(_unflatten(flat), dims, dtype=dtype, device=dev), dims
