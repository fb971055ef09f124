"""The plain reference against the port at a tiny size on the CPU, part
by part: the encode, the renders of both samplers, a training step's
draws, and the localizer's frame. (The harness's own runs compare the
whole timed path; ``test_portbench_run.py``.)"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.tests import helpers
from portbench.reference import field as F
from portbench.reference import localize as RL
from portbench.reference import train as RT

PB = pathlib.Path(__file__).resolve().parents[1]


def _configs(sampler: str):
    from f2nerf_tpu_torch.core.config import Config

    cfg = Config.quality() if sampler == "occ" else Config()
    model = dataclasses.replace(cfg.model, sample_near=0.0,
                                sampler_mode=sampler, **helpers.TINY_MODEL)
    cfg = dataclasses.replace(cfg, model=model)
    return cfg, F.model_ns(dataclasses.asdict(model))


def _field(model):
    return harness.load_module(PB / "fields" / "paged.py").features(
        model, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode(dtype):
    from f2nerf_tpu_torch.models import hash_field
    from f2nerf_tpu_torch.ops import hash_paged

    cfg, model = _configs("occ")
    params = inputs.map_weights(model, 2, 3, torch.device("cpu"))
    x = torch.rand((500, 3), generator=torch.Generator().manual_seed(1)) \
        * 4 - 2
    port = hash_paged.paged_encode(x, params["field"]["feat_pool"],
                                   hash_field.paged_meta(cfg.model),
                                   compute_dtype=dtype)
    ref = F.encode(params["field"]["feat_pool"], x, F.layout(model), dtype)
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sampler", ["occ", "dense"])
def test_render(sampler):
    from f2nerf_tpu_torch.models import occupancy, renderer
    from f2nerf_tpu_torch.train.step import draw_noise

    cfg, model = _configs(sampler)
    dev = torch.device("cpu")
    params = inputs.map_weights(model, 2, 4, dev)
    grid = inputs.seeded_grid(model, 5, dev)
    poses, intr = inputs.cameras(2, 16, 12.0, dev)
    cam, ij, _ = inputs.batch_data(np.random.default_rng(6), 32, 2, 16)
    cam = torch.as_tensor(cam).long()
    rays_o, rays_d = F.rays_from_pose(poses[cam], intr[cam],
                                      torch.as_tensor(ij).float())
    occ = occupancy.occ_values(grid, cfg.model)
    noise = draw_noise(cfg, 9, 32, dev)
    ref_noise = RT.draw_noise(model, dataclasses.asdict(cfg.train), 9, 32,
                              dev)
    for a, b in zip(noise[:6], ref_noise):
        if a is not None:
            assert torch.equal(a, b)
    port = renderer.render(params, rays_o, rays_d, cfg.model, occ_vals=occ,
                           noise=noise, emb_idx=cam)
    ref = F.render(params, rays_o, rays_d, model, _field(model),
                   F.table_dtype(model), occ_vals=F.occ_values(grid, model),
                   noise=ref_noise, emb_idx=cam)
    torch.testing.assert_close(ref.colors, port.colors, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ref.weights, port.weights, rtol=1e-5,
                               atol=1e-6)


def test_mode0_frame():
    from f2nerf_tpu_torch.core.config import Config
    from f2nerf_tpu_torch.localize.localizer import (Localizer,
                                                     LocalizerParam,
                                                     calc_average_pose)
    from f2nerf_tpu_torch.models import occupancy

    cfg, model = _configs("occ")
    dev = torch.device("cpu")
    params = inputs.map_weights(model, 2, 4, dev)
    grid = inputs.seeded_grid(model, 5, dev)
    full, small = inputs.frame_intrinsic((40, 96), 100.0, 8)
    loc = Localizer(params, Config(model=cfg.model), full, np.zeros(3), 1.0,
                    40, 96, param=LocalizerParam(resize_factor=8),
                    occ_vals=occupancy.occ_values(grid, cfg.model), seed=8,
                    device=dev)
    mp = RL.Map(params, model, _field(model), F.occ_values(grid, model),
                small, 5, 12, F.table_dtype(model))
    image = mp.image(np.eye(3, 4, dtype=np.float32) + 0.01)
    prior = np.eye(3, 4, dtype=np.float32)
    state = loc._rng.bit_generator.state
    parts = loc.optimize_pose_by_random_search(prior, image, 6, 2.0)
    ref = RL.mode0(mp, state, prior, 50.0, image, 6)
    np.testing.assert_allclose([p.weight for p in parts], ref["weights"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(calc_average_pose(parts), ref["pose"],
                               atol=1e-6)
