"""Configuration for training, model shape and rendering.

The port's own copy of ``f2nerf_tpu/core/config.py``: the same
dataclasses, field names and defaults, so a config written by the JAX
trainer (``train_config.yaml``) or ``dataclasses.asdict`` of a JAX config
loads here unchanged. The reasons behind each default are documented in
the JAX package; comments here say only what a field does.

:meth:`Config.load` and :meth:`Config.save` read and write YAML through
the port's own ``core/yaml_io.py``, so no ``yaml`` package is needed.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

from f2nerf_tpu_torch.core import yaml_io


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model shape."""

    # hash grid
    n_levels: int = 8
    n_channels: int = 4
    log2_table_size: int = 19       # entries per level = 2^19
    hash_mode: str = "paged"        # 'paged' | 'xor' (the reference's hash)
    init_seed: int = 2022           # numpy-side init (page constants)
    encode_chunk: int = 20480       # points per chunk of the plain encode
    encode_dedup: bool = True       # run dedup (exact; the port encodes flat)
    dedup_max_frac: float = 0.75
    res_base_pow2: float = 3.0      # per-level res = exp2(3 + 7*l/(L-1))
    res_fine_pow2: float = 10.0
    contraction_radius: float = 1.0
    hash_feat_dim: int = 16
    density_shift: float = 3.0
    warp_mode: str = "contract"     # 'contract' | 'perspective' (both ported)
    warp_n_regions: int = 64
    warp_n_cams: int = 4
    warp_blend_k: int = 3

    # SH shader
    sh_degree: int = 4
    shader_hidden_dim: int = 64
    app_emb_dim: int = 16

    # sampler
    n_samples: int = 1024
    sample_l: float = 1.0 / 256.0
    sampler_mode: str = "occ"       # 'occ' | 'dense'
    sample_near: float = 0.0
    dense_two_pass: bool = False     # TRAIN early-stop compaction (dense)
    dense_two_pass_dedup: bool = False   # exact either way; encodes flat
    occ_grid_res: int = 128
    occ_segments: int = 128
    occ_keep: int = 8
    occ_samples_per_segment: int = 8
    occ_update_every: int = 16
    occ_decay: float = 0.8
    occ_refresh_phases: int = 4
    occ_refresh_warmup: int = 2048
    occ_thresh: float = 0.01
    occ_warmup_steps: int = 512
    occ_trans_eps: float = 1e-6
    occ_elig_tau_cap: float = 4.6
    occ_mean_ema: float = 0.25
    occ_explore_slots: int = 1
    occ_explore_targeted: bool = True
    occ_explore_eps: float = 0.0

    # renderer
    trans_eps: float = 1e-4
    bf16_features: bool = True      # haloed table in bf16

    @property
    def table_size(self) -> int:
        return (1 << self.log2_table_size)

    @property
    def pool_size(self) -> int:
        return self.table_size * self.n_levels

    @property
    def sh_dim(self) -> int:
        return self.sh_degree * self.sh_degree

    @property
    def shader_in_dim(self) -> int:
        return self.hash_feat_dim + self.sh_dim

    def level_resolutions(self) -> list[float]:
        """Per-level scale mul = exp2(base + (fine-base)*l/(L-1))."""
        span = self.res_fine_pow2 - self.res_base_pow2
        denom = max(self.n_levels - 1, 1)
        return [2.0 ** (self.res_base_pow2 + span * lvl / denom)
                for lvl in range(self.n_levels)]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop knobs (reference confs/train_config.yaml keys)."""

    pts_batch_size: int = 262144
    end_iter: int = 20000
    report_freq: int = 200
    vis_freq: int = 2500
    save_freq: int = 20000
    learning_rate: float = 1e-2
    learning_rate_alpha: float = 1e-1
    learning_rate_warm_up_end_iter: int = 1000
    var_loss_weight: float = 1e-2
    var_loss_start: int = 5000
    var_loss_end: int = 10000
    var_loss_mode: str = "weight_var"
    grad_clip_norm: float = 0.0
    feat_pool_weight_decay: float = 0.0
    explore_sparsity_weight: float = 0.0
    global_sparsity_points: int = 8192
    global_sparsity_weight: float = 0.0
    grad_blocks: int = 0
    loss_scale: float = 1.0
    occ_reg_weight: float = 0.0
    occ_reg_t: float = 0.0
    level_anneal_end: int = 0
    train_app_emb: bool = True
    nan_recovery: int = 0
    seed: int = 2022
    ray_batch_size: int = 8192

    @property
    def rays_per_step(self) -> int:
        return (int(self.pts_batch_size / 512.0) >> 4) << 4


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @staticmethod
    def tiny() -> "Config":
        """CPU-runnable tiny config: 4-level hash grid (2^14 table),
        64 samples/ray, dense sampler."""
        return Config(
            model=ModelConfig(
                n_levels=4, log2_table_size=14, n_samples=64,
                sample_l=1.0 / 16.0, bf16_features=False,
                sampler_mode="dense"),
            train=TrainConfig(pts_batch_size=32768, end_iter=200,
                              report_freq=50, vis_freq=10**9,
                              save_freq=10**9,
                              learning_rate_warm_up_end_iter=20,
                              var_loss_start=50, var_loss_end=100),
        )

    @staticmethod
    def quality(end_iter: int = 20000) -> "Config":
        """Long-horizon quality operating point (same values as the JAX
        package's ``Config.quality``)."""
        return Config(
            model=ModelConfig(sample_near=-1.0),
            train=TrainConfig(pts_batch_size=4096 * 512,
                              end_iter=end_iter,
                              learning_rate=5e-3,
                              learning_rate_warm_up_end_iter=max(
                                  end_iter // 20, 1),
                              var_loss_mode="distortion",
                              var_loss_weight=1e-4,
                              var_loss_start=0,
                              var_loss_end=1,
                              explore_sparsity_weight=1e-2,
                              nan_recovery=2),
        )

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Config":
        model = ModelConfig(**d.get("model", {}))
        train = TrainConfig(**d.get("train", {}))
        return Config(model=model, train=train)

    @staticmethod
    def load(path: str | pathlib.Path) -> "Config":
        """Load a YAML config: this framework's layout ({model, train})
        or the reference's train_config.yaml layout ({train} only)."""
        raw = yaml_io.load(path) or {}
        train_d = dict(raw.get("train", {}))
        train_d.pop("validate_freq", None)
        known = {f.name for f in dataclasses.fields(TrainConfig)}
        train_d = {k: _coerce(v) for k, v in train_d.items() if k in known}
        model_d = dict(raw.get("model", {}))
        known_m = {f.name for f in dataclasses.fields(ModelConfig)}
        model_d = {k: _coerce(v) for k, v in model_d.items() if k in known_m}
        return Config(model=ModelConfig(**model_d), train=TrainConfig(**train_d))

    def save(self, path: str | pathlib.Path) -> None:
        """The text ``yaml.safe_dump(self.to_dict(), sort_keys=False)``
        gives."""
        yaml_io.dump(self.to_dict(), path)


def _coerce(v: Any) -> Any:
    """YAML 1.1 parses 1e-2 as str in some loaders; coerce numeric strings."""
    if isinstance(v, str):
        try:
            return json.loads(v)
        except (ValueError, TypeError):
            try:
                return float(v)
            except ValueError:
                return v
    return v
