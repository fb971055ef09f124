"""The parts benches of the port (``f2nerf_tpu_torch/tools/bench_*_parts``,
``bench_dense_trained``) against the JAX package's scripts
(``scripts/bench_*.py``) on the CPU, at tiny sizes.

* Each bench runs at a tiny config and prints every label the JAX script
  prints (the literal text before each printed number, taken from the
  script's source), each with its wall ms; the device ms reads "not
  measured" off the card.
* The numbers that are not times equal JAX's: ``bench_encode_parts``' and
  ``bench_dense_parts``' dedup budgets, and ``bench_dense_trained``'s
  statistics lines (survivor prefix, survivor share, pseudo-row run
  counts) on one dense field saved in both packages' checkpoint formats,
  with JAX's sampler jitter given to the port.
* ``main`` takes ``--device`` only (and ``bench_dense_trained`` the JAX
  script's positional arguments), so the default run measures the JAX
  script's point.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from f2nerf_tpu.core.config import Config as JConfig
from f2nerf_tpu.models import hash_field as jhf
from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrenderer
from f2nerf_tpu.train import checkpoint as jckpt
from f2nerf_tpu.train.optim import make_optimizer as jmake_optimizer
from f2nerf_tpu_torch.convert import tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.tools import (bench_dense_parts, bench_dense_trained,
                                    bench_encode_parts, bench_step_parts)
from f2nerf_tpu_torch.train import checkpoint as tckpt
from f2nerf_tpu_torch.train.optim import make_optimizer

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The benches run thousands of tiny ops: with a thread pool each on
    a machine that other test workers share, they wait on each other far
    longer than they compute."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_labels(name: str) -> list[str]:
    """The literal text before the first number of each ``print`` in
    ``scripts/<name>.py``, stripped."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    labels = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print" and node.args):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and arg.value.strip():
                labels.append(arg.value.strip())
    return labels


def _check_labels(name: str, lines: list[str]) -> None:
    labels = _jax_labels(name)
    assert labels
    for label in labels:
        assert any(line.strip().startswith(label) for line in lines), label


def _occ_tiny(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sampler_mode="occ", occ_grid_res=16, occ_segments=16))


def test_kernel_ms_sums_the_cards_events():
    """``common.kernel_ms`` sums the durations of the raw profile events
    that ran on the card and leaves out user annotations, which span
    kernels counted on their own, and host events."""
    from types import SimpleNamespace

    from f2nerf_tpu_torch.tools.common import kernel_ms

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(device, ns, annotation=False):
        return SimpleNamespace(device_type=lambda: device,
                               duration_ns=lambda: ns,
                               is_user_annotation=lambda: annotation)

    events = [event(cuda, 1_500_000),            # a kernel
              event(cuda, 250_000),              # a copy
              event(cuda, 9_000_000_000, True),  # Optimizer.step#Adam.step
              event(cpu, 7_000_000_000),         # aten::mul on the host
              event(cpu, 3_000_000, True),       # a host-side range
              event(cuda, 125_000)]
    assert kernel_ms(events) == pytest.approx(1.875, rel=0, abs=1e-12)
    assert kernel_ms([]) == 0.0


def test_time_part_measures_no_device_off_the_card():
    """On the CPU the part is called once, then ``iters`` times; its wall
    time is measured and its device time and busy share stay None."""
    from f2nerf_tpu_torch.tools.common import part_line, time_part

    calls = []
    t = time_part(lambda: calls.append(1), "cpu", iters=3)
    assert len(calls) == 4
    assert t["wall_ms"] >= 0
    assert t["device_ms"] is None and t["busy_share"] is None
    assert part_line("x:", t).endswith("ms (device not measured)")
    shown = part_line("x:", {"wall_ms": 4.0, "device_ms": 1.0,
                             "busy_share": 0.25})
    assert shown == "x:     4.00 ms (device     1.00 ms, busy 25.0%)"


def test_step_parts_tiny():
    cfg = _occ_tiny(TConfig.tiny())
    out = bench_step_parts.measure(cfg, rays=64, device="cpu", iters=2)
    lines = bench_step_parts.report(out, cfg)
    _check_labels("bench_step_parts", lines)
    assert len(lines) == 6
    for t in out.values():
        assert t["wall_ms"] > 0 and t["device_ms"] is None
    assert all(line.endswith("(device not measured)") for line in lines)
    assert "ms/step amortized" in lines[-1]


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_encode_parts_budgets_equal_jax(which):
    """The budgets the bench prints equal JAX's at the bench's config;
    the whole bench runs at the tiny one."""
    jcfg = _occ_tiny(JConfig.tiny()) if which == "tiny" else JConfig()
    tcfg = _occ_tiny(TConfig.tiny()) if which == "tiny" else TConfig()
    assert thf.ray_budgets(tcfg.model) == jhf.ray_budgets(jcfg.model)
    if which == "default":
        return
    out = bench_encode_parts.measure(tcfg, rays=32, device="cpu", iters=2)
    assert out["budgets"] == jhf.ray_budgets(jcfg.model) == (24, 0, 0, 0)
    lines = bench_encode_parts.report(out)
    _check_labels("bench_encode_parts", lines)
    assert len(lines) == 5


def test_dense_parts_tiny():
    cfg = TConfig.tiny()
    out = bench_dense_parts.measure(cfg, rays=16, device="cpu", iters=2)
    jm = dataclasses.replace(JConfig.tiny().model, sampler_mode="dense")
    assert out["budgets"] == jhf.ray_budgets(jm)
    lines = bench_dense_parts.report(out, 16)
    _check_labels("bench_dense_parts", lines)
    assert lines[0] == (f"dense point: 16 rays x 64 samples, budgets="
                        f"{jhf.ray_budgets(jm)}")
    assert len(lines) == 9
    # the JAX script's 22-column labels
    assert lines[1].startswith("dense sampler:        ")


def test_mains_take_only_device(monkeypatch):
    """The CLI adds ``--device`` to each script's own arguments."""
    seen = []

    def stop(*a, **kw):
        seen.append((a, kw))
        raise KeyboardInterrupt

    for mod in (bench_step_parts, bench_encode_parts, bench_dense_parts):
        monkeypatch.setattr(mod, "measure", stop)
        with pytest.raises(KeyboardInterrupt):
            mod.main(["--device", "cpu"])
        with pytest.raises(SystemExit):
            mod.main(["--rays", "4"])
    assert all(kw == {"device": "cpu"} for _, kw in seen)
    assert [type(a[0]) for a, _ in seen] == [TConfig] * 3
    assert seen[0][0][0] == TConfig()
    monkeypatch.setattr(bench_dense_trained, "measure", stop)
    with pytest.raises(KeyboardInterrupt):
        bench_dense_trained.main(["r", "stats", "64", "1e-3", "--device",
                                  "cpu"])
    assert seen[-1] == (("r", "stats", 64, 1e-3), {"device": "cpu"})
    with pytest.raises(KeyboardInterrupt):
        bench_dense_trained.main([])
    assert seen[-1] == (("_runs/r2_dense20k", "all", 512, None),
                        {"device": None})


# -- bench_dense_trained on one field in both formats ----------------------

RAYS, N_IMAGES, HW = 16, 4, 16
DENSITY_BIAS = 4.0      # raises the raw density: some rays stop early


def _dense_cfg(config):
    cfg = config.tiny()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_samples=512))


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    """One seeded dense field with a raised density bias, saved as a JAX
    run (Orbax) and as a port run (``state.pt``), each with the same
    ``train_config.yaml`` and ``inference_params.yaml``."""
    root = tmp_path_factory.mktemp("dense_runs")
    jcfg = _dense_cfg(JConfig)
    params, consts = jrenderer.init(jax.random.key(0), jcfg.model, N_IMAGES)
    params["field"]["mlp"]["b"] = params["field"]["mlp"]["b"].at[0].set(
        DENSITY_BIAS)
    ip = {"n_images": N_IMAGES, "height": HW, "width": HW}
    for d in ("jax", "port"):
        (root / d).mkdir()
        jcfg.save(root / d / "train_config.yaml")
        (root / d / "inference_params.yaml").write_text(yaml.safe_dump(ip))
    jopt = jmake_optimizer(jcfg.train)
    jckpt.save(root / "jax" / "checkpoints", 7, params, jopt.init(params),
               consts, extra={"occ_grid": jocc.init_grid(jcfg.model)})
    tparams = tree_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tcfg = TConfig.load(root / "port" / "train_config.yaml")
    tckpt.save(root / "port" / "checkpoints", 7, tparams,
               make_optimizer(tparams, tcfg.train))
    return root


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_draws(rays, samples, dev):
    """JAX's sampler jitter of the statistics (``key(1)``)."""
    u = jax.random.uniform(jax.random.key(1), (rays, samples))
    return torch.tensor(np.asarray(u), device=dev)


def test_dense_trained_stats_equal_jax(dense_runs, monkeypatch):
    run_j, run_t = dense_runs / "jax", dense_runs / "port"
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["bench_dense_trained", str(run_j),
                                      "stats", str(RAYS)])
    with contextlib.redirect_stdout(buf):
        assert _jax_script("bench_dense_trained").main() == 0
    want = buf.getvalue().splitlines()
    monkeypatch.setattr(bench_dense_trained, "march_draws", _jax_draws)
    out = bench_dense_trained.measure(run_t, "stats", RAYS, device="cpu")
    got = out["lines"]
    assert len(got) == len(want) > 4
    assert got[0] == f"restored step 7 from {run_t}"
    assert got[1:] == want[1:]
    # a share between the extremes, and the bucket's budgets in force
    assert 0.1 < out["share"] < 0.9
    assert any(b for _, _, b in out["runs"].values())
    _check_labels("bench_dense_trained", got + ["trans_eps override: ",
                                                "two_pass="])


def test_dense_trained_arms_run(dense_runs):
    """Every step variant runs on the restored field and is timed; the
    restored params are the checkpoint's for each."""
    out = bench_dense_trained.measure(dense_runs / "port", "all", RAYS,
                                      trans_eps=1e-3, device="cpu", iters=1)
    lines = out["lines"]
    assert lines[0] == "trans_eps override: 0.001"
    arms = [line for line in lines if line.startswith("two_pass=")]
    assert [a.split(":")[0] for a in arms] == [
        "two_pass=True surv_dedup=True", "two_pass=True surv_dedup=False",
        "two_pass=False surv_dedup=False"]
    assert all("rays/s" in a and a.endswith("(device not measured)")
               for a in arms)
    assert all(t["wall_ms"] > 0 for t in out["arms"].values())
    with pytest.raises(ValueError, match="not a dense run"):
        occ = dense_runs / "occ"
        occ.mkdir(exist_ok=True)
        _occ_tiny(TConfig.tiny()).save(occ / "train_config.yaml")
        bench_dense_trained.measure(occ, "stats", RAYS, device="cpu")
