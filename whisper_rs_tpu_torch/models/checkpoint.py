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
    ``ModelDims``).  Floating leaves take ``dtype``; int8 leaves (the
    weights of ``quantize_params``) stay int8, as in the JAX
    ``load_params``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    dims = _dims_from(json.loads(bytes(flat.pop("__dims__")).decode()))
    return params_from_jax(_unflatten(flat), dims, dtype=dtype, device=dev), dims
