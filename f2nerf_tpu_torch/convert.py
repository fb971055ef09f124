"""Carry parameters across from the JAX package.

The JAX params pytree (``f2nerf_tpu/models/renderer.py:57-63``) is

* ``field.feat_pool`` [P_total, C, 4, 4, 4]
* ``field.mlp.{w [L*C, 16], b [16]}``
* ``shader.{w0 [32, 64], b0, w1 [64, 3], b1}``
* ``app_emb`` [n_images, 16]

The port keeps that layout and applies weights as ``x @ w``, so every
array is carried over unchanged (no transposes).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def params_from_numpy(tree: Mapping[str, Any],
                      device: torch.device | str) -> dict[str, Any]:
    """Nested dict of numpy arrays (the JAX params pytree after
    ``jax.tree.map(np.asarray, params)``) -> the port's params, float32
    tensors on ``device``. The arrays are copied: JAX hands out read-only
    buffers, and the port's tensors must not alias them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = params_from_numpy(v, device)
        else:
            out[k] = torch.tensor(np.asarray(v, dtype=np.float32),
                                  device=device)
    return out


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {"field/feat_pool": ..., "shader/w0": ...}."""
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten(v, name + "/"))
        else:
            flat[name] = v
    return flat


def unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`flatten`."""
    tree: dict[str, Any] = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree
