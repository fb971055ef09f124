"""Port parity for the training loop and its checkpoints
(``f2nerf_tpu_torch.train.loop`` / ``train.checkpoint`` against
``f2nerf_tpu.train.loop``) on the CPU, in fp32.

The parity runs give both trainers one dataset, the same params (the JAX
trainer's init, converted), the same batches (both take them from the
native loader, or both from ``sample_batch`` on one seed) and the JAX
step's own draws (``test_torch_train.jax_noise`` through the port's
``noise_fn``), then take 4 steps with a report every 2.

Tolerances (those of ``tests/test_torch_train.py``):
* the log's PSNR and LOSS columns: rtol 1e-5, plus 1e-6 for the six
  printed decimals; LR and OCC columns equal as printed;
* params after the run: atol 0.05 x the largest lr of the run (an Adam
  step moves a param by about lr whatever its grad, so f32 rounding in
  another order shows in units of lr);
* occupancy grid: rtol 1e-5, atol 1e-7.

Resume is bitwise; the recovery scenarios are those of
``tests/test_train.py``.
"""

import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch
from test_torch_train import jax_noise

from f2nerf_tpu.train.loop import Trainer as JTrainer
from f2nerf_tpu_torch.convert import flatten
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.train import checkpoint as tckpt
from f2nerf_tpu_torch.train.loop import Trainer as TTrainer
from f2nerf_tpu_torch.train.optim import lr_schedule

N_STEPS = 4
_LINE = re.compile(r"Iter:\s+(\d+) PSNR: (\S+) LOSS: (\S+) LR: (\S+)"
                   r"(?: OCC: (\S+))?")


def _port_ds(ds):
    return tdata.Dataset(**{f.name: getattr(ds, f.name)
                            for f in dataclasses.fields(tdata.Dataset)})


def _log(path):
    return [m.groups() for m in map(_LINE.search,
                                    path.read_text().splitlines()) if m]


def _tcfg(jcfg):
    return TConfig.from_dict(dataclasses.asdict(jcfg))


def _parity_run(jcfg, ds, tmp_path):
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, report_freq=2))
    jtr = JTrainer(jcfg, ds, result_dir=tmp_path / "jax", use_mesh=False)
    tree = jax.tree.map(np.asarray, jtr.params)
    ttr = TTrainer(_tcfg(jcfg), _port_ds(ds), result_dir=tmp_path / "port",
                   device="cpu", params=tree,
                   noise_fn=lambda step, n: jax_noise(jcfg, step, n))
    assert ttr.batch_source == ("native" if jtr._native is not None
                                else "numpy")
    jtr.run(N_STEPS)
    ttr.run(N_STEPS)
    ttr.close()
    lr = lr_schedule(ttr.cfg.train)
    return jtr, ttr, max(lr(count) for count in range(N_STEPS))


@pytest.fixture(scope="module")
def parity(tiny_cfg, occ_cfg, sphere_ds, tmp_path_factory):
    def run(name, cfg):
        return _parity_run(cfg, sphere_ds, tmp_path_factory.mktemp(name))
    return {"tiny": run("tiny", tiny_cfg), "occ": run("occ", occ_cfg)}


@pytest.mark.parametrize("which", ["tiny", "occ"])
def test_loop_log_matches_jax(which, parity):
    jtr, ttr, _ = parity[which]
    jl = _log(jtr.result_dir / "train_log.txt")
    tl = _log(ttr.result_dir / "train_log.txt")
    assert [int(r[0]) for r in tl] == [2, 4]     # one report every 2 steps
    assert len(jl) == len(tl) == N_STEPS // 2
    for j, t in zip(jl, tl):
        assert t[0] == j[0]
        for col in (1, 2):
            np.testing.assert_allclose(float(t[col]), float(j[col]),
                                       rtol=1e-5, atol=1e-6)
        assert t[3] == j[3]                     # LR as printed
        assert t[4] == j[4]                     # OCC (None in dense mode)
    assert (tl[0][4] is not None) == (which == "occ")


@pytest.mark.parametrize("which", ["tiny", "occ"])
def test_loop_params_match_jax(which, parity):
    jtr, ttr, lr_max = parity[which]
    assert lr_max > 0.0 and jtr.step == ttr.step == N_STEPS
    jflat = flatten(jax.tree.map(np.asarray, jtr.params))
    tflat = {k: p.detach().numpy() for k, p in ttr.optimizer.named.items()}
    assert set(jflat) == set(tflat)
    for name, pj in jflat.items():
        np.testing.assert_allclose(tflat[name], pj, rtol=0,
                                   atol=0.05 * lr_max, err_msg=name)
    assert ttr.optimizer.count == N_STEPS


def test_loop_occ_grid_matches_jax(parity):
    jtr, ttr, _ = parity["occ"]
    np.testing.assert_allclose(ttr.occ_grid.numpy(), np.asarray(jtr.occ_grid),
                               rtol=1e-5, atol=1e-7)


def test_loop_writes_the_run_files(parity):
    """train_config.yaml and inference_params.yaml: the JAX trainer's
    text; the config reads back as the trainer's."""
    jtr, ttr, _ = parity["tiny"]
    for name in ("train_config.yaml", "inference_params.yaml"):
        assert ((ttr.result_dir / name).read_text()
                == (jtr.result_dir / name).read_text()), name
    assert TConfig.load(ttr.result_dir / "train_config.yaml") == ttr.cfg


# -- checkpoints and resume --------------------------------------------------


def _trainer(cfg, ds, rd, **kw):
    return TTrainer(_tcfg(cfg), _port_ds(ds), result_dir=rd, device="cpu",
                    **kw)


@pytest.fixture()
def occ_small(occ_cfg):
    return dataclasses.replace(occ_cfg, train=dataclasses.replace(
        occ_cfg.train, report_freq=2))


def test_resume_is_bitwise(occ_small, sphere_ds, tmp_path):
    a = _trainer(occ_small, sphere_ds, tmp_path)
    a.run(3)
    a.save_checkpoint()
    b = _trainer(occ_small, sphere_ds, tmp_path)
    assert b.step == 0 and b.try_resume()
    assert b.step == 3 == a.step
    for (na, pa), (nb, pb) in zip(a.optimizer.named.items(),
                                  b.optimizer.named.items()):
        assert na == nb and torch.equal(pa, pb), na
        sa, sb = a.optimizer.adam.state[pa], b.optimizer.adam.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), (na, k)
    assert torch.equal(a.occ_grid, b.occ_grid)
    assert b.optimizer.count == a.optimizer.count == 3
    assert ([g["lr"] for g in b.optimizer.adam.param_groups]
            == [g["lr"] for g in a.optimizer.adam.param_groups])
    # the resumed trainer trains on
    b.run(1)
    assert b.step == 4 and b.optimizer.count == 4
    a.close()
    b.close()


def test_checkpoint_retention(tiny_cfg, sphere_ds, tmp_path):
    tr = _trainer(tiny_cfg, sphere_ds, tmp_path)
    for _ in range(3):
        tr.run(2)
        tr.save_checkpoint()
    tr.close()
    d = tmp_path / "checkpoints"
    assert sorted(p.name for p in d.glob("step_*")) == [
        "step_00000004", "step_00000006"]              # keep_last=2
    assert tckpt.latest_step(d) == 6
    state = tckpt.restore(d, step=4)
    assert state["step"] == 4 and state["count"] == 4
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "nowhere")


def test_legacy_grid_is_widened(occ_small, sphere_ds, tmp_path):
    """A checkpoint holding a [G, G, G] max-EMA grid resumes with an empty
    mean channel."""
    tr = _trainer(occ_small, sphere_ds, tmp_path)
    tr.run(1)
    tr.save_checkpoint()
    tr.close()
    path = tmp_path / "checkpoints" / "step_00000001" / tckpt.STATE_FILE
    state = torch.load(path, weights_only=True)
    legacy = state["occ_grid"][0].clone()
    state["occ_grid"] = legacy
    torch.save(state, path)
    b = _trainer(occ_small, sphere_ds, tmp_path)
    assert b.try_resume()
    assert b.occ_grid.shape == (2, *legacy.shape)
    assert torch.equal(b.occ_grid[0], legacy)
    assert float(b.occ_grid[1].abs().max()) == 0.0
    b.close()


# -- NaN handling ------------------------------------------------------------


def _poison(tensors):
    with torch.no_grad():
        for t in tensors:
            t.fill_(float("nan"))


def test_nan_raises(tiny_cfg, sphere_ds):
    """nan_recovery = 0: a NaN loss raises at the next report (the
    reference CHECKs NaN each iteration, train_manager.cpp:98-100)."""
    tr = TTrainer(_tcfg(tiny_cfg), _port_ds(sphere_ds), device="cpu")
    _poison(tr.optimizer.named.values())
    with pytest.raises(FloatingPointError, match="NaN loss"):
        tr.run(2)


def test_nan_recovery_restores_finite_checkpoint(tiny_cfg, sphere_ds,
                                                 tmp_path):
    """nan_recovery > 0: a NaN loss rolls back to the newest all-finite
    checkpoint and training continues; a poisoned newer checkpoint is
    skipped; once the budget is spent a NaN raises."""
    cfg = dataclasses.replace(tiny_cfg, train=dataclasses.replace(
        tiny_cfg.train, nan_recovery=1, report_freq=2))
    tr = _trainer(cfg, sphere_ds, tmp_path)
    tr.run(4)
    tr.save_checkpoint()                  # finite checkpoint @ step 4
    _poison(tr.optimizer.named.values())
    tr.step = 6
    tr.save_checkpoint()                  # poisoned checkpoint @ step 6
    tr.run(2)                             # first report raises -> recover
    assert tr.step >= 6
    assert all(bool(torch.isfinite(p).all())
               for p in tr.optimizer.named.values())
    log = (tmp_path / "train_log.txt").read_text()
    assert "NAN-RECOVER: restored finite checkpoint step 4" in log
    _poison(tr.optimizer.named.values())
    with pytest.raises(FloatingPointError):
        tr.run(4)
    tr.close()


def test_nan_recovery_rejects_poisoned_opt_state(tiny_cfg, sphere_ds,
                                                 tmp_path):
    """A checkpoint with finite params but NaN Adam moments is refused."""
    cfg = dataclasses.replace(tiny_cfg, train=dataclasses.replace(
        tiny_cfg.train, nan_recovery=1, report_freq=2))
    tr = _trainer(cfg, sphere_ds, tmp_path)
    tr.run(4)
    tr.save_checkpoint()                  # fully finite @ step 4
    _poison(s["exp_avg"] for s in tr.optimizer.adam.state.values())
    tr.step = 6
    tr.save_checkpoint()
    assert tr._recover()
    assert tr.step == 4                   # the step-6 checkpoint was refused
    for p in tr.optimizer.named.values():
        assert bool(torch.isfinite(p).all())
        st = tr.optimizer.adam.state[p]
        assert bool(torch.isfinite(st["exp_avg"]).all())
        assert bool(torch.isfinite(st["exp_avg_sq"]).all())
    tr.close()


def test_auto_sample_near(tiny_cfg, sphere_ds):
    """sample_near = -1 resolves to the dataset's smallest near bound in
    normalized units, as the JAX trainer resolves it; beyond 1.5 it is
    clamped."""
    cfg = dataclasses.replace(tiny_cfg, model=dataclasses.replace(
        tiny_cfg.model, sample_near=-1.0))
    jtr = JTrainer(cfg, sphere_ds, use_mesh=False)
    ttr = TTrainer(_tcfg(cfg), _port_ds(sphere_ds), device="cpu")
    assert ttr.cfg.model.sample_near == jtr.cfg.model.sample_near > 0
    far = dataclasses.replace(sphere_ds, bounds=sphere_ds.bounds * 100)
    assert TTrainer(_tcfg(cfg), _port_ds(far),
                    device="cpu").cfg.model.sample_near == 1.5


def test_profiler_window(tiny_cfg, sphere_ds, tmp_path):
    """profile_dir: steps profile_steps[0] .. profile_steps[1] traced with
    torch.profiler into one Chrome trace, which holds the step's spans
    (utils/trace.py) for each traced step."""
    tr = TTrainer(_tcfg(tiny_cfg), _port_ds(sphere_ds), device="cpu",
                  profile_dir=tmp_path / "prof", profile_steps=(1, 3))
    tr.run(4)
    traces = list((tmp_path / "prof").glob("*.json"))
    assert [p.name for p in traces] == ["train_steps_1_3.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("step", "step.noise", "step.forward", "step.backward",
                 "step.optimizer", "render.sample", "render.field",
                 "render.shade", "render.composite"):
        assert names.count(name) == 2, name


def test_trainer_needs_a_card_by_default(tiny_cfg, sphere_ds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTrainer(_tcfg(tiny_cfg), _port_ds(sphere_ds))
