#!/usr/bin/env python
"""Convert a JAX run directory into the ``torch_params.npz`` that the
PyTorch port's ``Localizer.from_checkpoint`` reads, so that the port
serves (``f2nerf_tpu_torch.apps.serve``, ``apps.ros2_node``), tests and
renders a map the JAX trainer made.

Needs the JAX package (``jax``, ``orbax``); imports nothing of the port.

    python scripts/export_torch_params.py <run_dir> [--out PATH]

The newest Orbax checkpoint of ``<run_dir>/checkpoints`` is restored
with a template shaped as the JAX trainer's state (``renderer.init``
with ``np_seed = cfg.train.seed``, as the JAX ``Trainer`` calls it: in ``hash_mode="xor"`` its consts hold the hash
constants; in ``warp_mode="perspective"`` the template also holds the
warp tables, shaped [min(warp_n_regions, n_images), 3] and
[.., 128]: the JAX ``Localizer.from_checkpoint`` has no such template
and refuses a warp run). The template gives Orbax the tree and the
shapes; every value comes from the checkpoint. The file holds

* the params flattened, "field/feat_pool", "field/mlp/w", ...,
  "app_emb";
* "occ_grid", the occupancy grid;
* the field's constants under "consts/field/" ("primes" (uint32),
  "biases", "scales" in xor mode; "warp_anchors", "warp_rows" in
  perspective mode).

It is written to ``<run_dir>/torch_params.npz`` unless ``--out`` says
otherwise.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Any

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def export(run_dir: str | pathlib.Path, out: str | pathlib.Path | None = None
           ) -> pathlib.Path:
    """Write the run's ``torch_params.npz`` (see the module docstring);
    returns its path."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import yaml

    from f2nerf_tpu.core.config import Config
    from f2nerf_tpu.models import occupancy, renderer
    from f2nerf_tpu.models.warp import WARP_ROW
    from f2nerf_tpu.train import checkpoint as ckpt_lib
    from f2nerf_tpu.train.optim import make_optimizer

    d = pathlib.Path(run_dir)
    text = (d / "inference_params.yaml").read_text()
    ip = yaml.safe_load(text.replace("%YAML 1.2", "").replace("---", ""))
    cfg = Config.load(d / "train_config.yaml")
    params, consts = renderer.init(jax.random.key(cfg.train.seed), cfg.model,
                                   ip["n_images"], np_seed=cfg.train.seed)
    if cfg.model.warp_mode == "perspective":
        m = min(cfg.model.warp_n_regions, ip["n_images"])
        consts["field"]["warp_anchors"] = jnp.zeros((m, 3), jnp.float32)
        consts["field"]["warp_rows"] = jnp.zeros((m, WARP_ROW), jnp.float32)
    template = {"params": params,
                "opt_state": make_optimizer(cfg.train).init(params),
                "consts": consts, "step": 0,
                "extra": {"occ_grid": occupancy.init_grid(cfg.model)}}
    try:
        state = ckpt_lib.restore(d / "checkpoints", template)
    except ValueError:
        # a checkpoint written before the two-channel occupancy grid
        # holds the [G, G, G] max-EMA only (JAX Trainer.try_resume)
        template["extra"]["occ_grid"] = template["extra"]["occ_grid"][0]
        state = ckpt_lib.restore(d / "checkpoints", template)
    flat = _flatten(jax.tree.map(np.asarray, state["params"]))
    flat["occ_grid"] = np.asarray(state["extra"]["occ_grid"])
    flat.update(_flatten(jax.tree.map(np.asarray, state["consts"]),
                         "consts/"))
    path = pathlib.Path(out) if out is not None else d / "torch_params.npz"
    np.savez(path, **flat)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None,
                    help="output file (default <run_dir>/torch_params.npz)")
    args = ap.parse_args(argv)
    path = export(args.run_dir, args.out)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
