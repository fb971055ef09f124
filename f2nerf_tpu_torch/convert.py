"""Carry parameters and training state across from the JAX package.

The JAX params pytree (``f2nerf_tpu/models/renderer.py:57-63``) is

* ``field.feat_pool`` [P_total, C, 4, 4, 4]
* ``field.mlp.{w [L*C, 16], b [16]}``
* ``shader.{w0 [32, 64], b0, w1 [64, 3], b1}``
* ``app_emb`` [n_images, 16]

The port keeps that layout and applies weights as ``x @ w``, so every
array is carried over unchanged (no transposes). The non-trained
``consts`` tree (``renderer.init``'s second output: in ``hash_mode="xor"``
``field.primes`` [L, 3] uint32, ``field.biases`` [L, 3] and
``field.scales`` [L]; in ``warp_mode="perspective"`` the warp tables
``field.warp_anchors`` [M, 3] and ``field.warp_rows`` [M, 128] that the
JAX ``Trainer`` adds) carries over as a dict of its own, the primes as
int64: the port keeps it out of ``params`` and so out of Adam. The occupancy grid ([2, G, G, G])
carries over as it is, and the optax state of
``f2nerf_tpu.train.optim.make_optimizer`` maps onto the port's
``train.optim.Optimizer`` (Adam moments, count and schedule count).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def tree_from_numpy(tree: Mapping[str, Any],
                    device: torch.device | str) -> dict[str, Any]:
    """Nested dict of numpy arrays (a JAX params or consts pytree after
    ``jax.tree.map(np.asarray, tree)``) -> the same nesting of tensors on
    ``device``: float arrays become float32, integer arrays (the xor
    hash's uint32 ``primes``) int64. The arrays are copied: JAX hands out
    read-only buffers, and the port's tensors must not alias them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = tree_from_numpy(v, device)
            continue
        a = np.asarray(v)
        dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32
        out[k] = torch.tensor(a.astype(dtype), device=device)
    return out


def occ_grid_from_numpy(grid: Any, device: torch.device | str
                        ) -> torch.Tensor:
    """The JAX occupancy grid (numpy) -> a float32 tensor on ``device``."""
    return torch.tensor(np.asarray(grid, dtype=np.float32), device=device)


def _optax_states(state: Any):
    """Yield the NamedTuple states inside an optax chain state."""
    if hasattr(state, "_fields"):
        yield state
        for v in state:
            yield from _optax_states(v)
    elif isinstance(state, (tuple, list)):
        for v in state:
            yield from _optax_states(v)


def opt_state_from_numpy(optimizer, state: Any) -> None:
    """Load the JAX optimizer state (after ``jax.tree.map(np.asarray,
    opt_state)``) into ``optimizer`` (a ``train.optim.Optimizer``).

    optax's ``ScaleByAdamState(count, mu, nu)`` becomes torch Adam's
    per-param ``step``, ``exp_avg`` and ``exp_avg_sq``; the
    ``ScaleByScheduleState`` count becomes the LR schedule's count. The
    state is found by its fields, so this module imports no optax.
    """
    adam = sched = None
    for s in _optax_states(state):
        if {"count", "mu", "nu"} <= set(s._fields):
            adam = s
        elif s._fields == ("count",):
            sched = s
    if adam is None or sched is None:
        raise ValueError("no ScaleByAdamState / ScaleByScheduleState found")
    mu, nu = flatten(adam.mu), flatten(adam.nu)
    if set(mu) != set(optimizer.named):
        raise ValueError(f"state leaves {sorted(mu)} do not match the "
                         f"optimizer's {sorted(optimizer.named)}")
    for name, p in optimizer.named.items():
        optimizer.adam.state[p] = {
            # a capturable Adam (on a CUDA device) counts on the device
            "step": torch.tensor(float(np.asarray(adam.count)),
                                 dtype=torch.float32,
                                 device=p.device if optimizer.capturable
                                 else None),
            "exp_avg": torch.tensor(np.asarray(mu[name], np.float32),
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name], np.float32),
                                       device=p.device)}
    optimizer.set_count(int(np.asarray(sched.count)))


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
