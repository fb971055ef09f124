"""Parity of ``f2nerf_tpu_torch.bench`` and ``f2nerf_tpu_torch.graft_entry``
with the JAX system's ``bench.py`` and ``__graft_entry__.py``.

* Bench set-up, per arm: the script's ``main`` runs with ``jax.jit``
  replaced by a recorder (nothing compiles), its watchdog a no-op and
  ``renderer.init`` a stub (no weights: the rate does not read them);
  the port's ``measure`` runs with a recording step. The step ids, the
  batches, the seeded grid, the cameras and the warp tables must be
  bitwise equal, the configs and unit strings equal, and the JSON line
  for a given value equal.
* The watchdog: the script's ``_watchdog`` and the port's
  ``BenchRun.watchdog`` (sleep skipped, ``os._exit`` raising, the git
  sha fixed) emit the same line in each branch.
* The CLI: ``python -m f2nerf_tpu_torch.bench --quick --device cpu`` in a
  process where jax, PIL, yaml and the JAX package fail to import.
* ``entry``: the script's jitted render and the port's on a tiny
  occupancy config (``Config`` patched in both packages), JAX's params
  converted and JAX's rays: colors and depths within 1e-5 (f32 through
  different op orders; the depths are O(1)).

The dry run's arms across ranks are in ``test_torch_parallel.py`` (one
set of gloo ranks for the whole module).
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import f2nerf_tpu.core.config as jconfig
import f2nerf_tpu.models.renderer as jrend
import f2nerf_tpu.train.step as jstep
from f2nerf_tpu_torch import bench, graft_entry
from f2nerf_tpu_torch.convert import tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENTRY_TOL = 1e-5


def _load(name: str, file: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load("jax_bench", "bench.py")


class _Stop(Exception):
    pass


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     None if a.choices is None else tuple(a.choices),
                     a.nargs, a.required, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def _parser(monkeypatch, run) -> argparse.ArgumentParser:
    caught = {}

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Stop

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Stop):
            run()
    return caught["parser"]


def test_bench_flags_match_the_script(script, monkeypatch):
    want = _flags(_parser(monkeypatch, script.main))
    got = _flags(_parser(monkeypatch, lambda: bench.main([])))
    assert got.pop("device")[:2] == (("--device",), None)
    assert got == want


# -- the arms' set-up ---------------------------------------------------------

ARGVS = {"quick": ["--quick"], "default": [], "dense": ["--dense"],
         "warp": ["--warp", "perspective"],
         "noqm": ["--no-quality-machinery"], "rays64": ["--rays", "64"]}


def _script_run(script, monkeypatch, capsys, tmp_path, argv):
    """The script's ``main`` on ``argv`` with a recording ``jax.jit``: its
    config, each step call's inputs, and its printed line."""
    calls, cfgs = [], []

    def step(params, opt_state, occ_grid, consts, poses, intr, step, cam,
             ij, gt):
        calls.append({"step": int(step), "cam": np.asarray(cam),
                      "ij": np.asarray(ij), "gt": np.asarray(gt),
                      "grid": np.asarray(occ_grid), "consts": consts,
                      "poses": np.asarray(poses), "intr": np.asarray(intr)})
        return params, opt_state, occ_grid, types.SimpleNamespace(loss=0.5)

    def make_train_step(cfg, optimizer):
        cfgs.append(cfg)
        return None

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: step)
    monkeypatch.setattr(jstep, "make_train_step", make_train_step)
    monkeypatch.setattr(jrend, "init",
                        lambda key, cfg, n: ({}, {"field": {}}))
    monkeypatch.setattr(script, "_watchdog", lambda budget_s: None)
    monkeypatch.setattr(script, "_git_sha", lambda: "sha")
    monkeypatch.setattr(script, "SELF_CACHE", tmp_path / "BENCH_SELF.json")
    monkeypatch.setattr(script, "_emitted", False)
    monkeypatch.setattr(script, "_best",
                        {"value": None, "unit": None, "iters_done": 0})
    monkeypatch.setattr(script, "_arm", {"key": None})
    capsys.readouterr()
    script.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return cfgs[0], calls, line


def _port_run(monkeypatch, argv):
    """The port's ``measure`` on ``argv`` on the CPU with a recording
    step: its config, each step call's inputs, and its result."""
    calls, cfgs = [], []

    def make_train_step(cfg, optimizer):
        cfgs.append(cfg)

        def step(params, grid, poses, intr, step, cam, ij, gt, consts=None):
            calls.append({"step": step, "cam": cam.numpy(), "ij": ij.numpy(),
                          "gt": gt.numpy(), "grid": grid.numpy(),
                          "consts": consts, "poses": poses.numpy(),
                          "intr": intr.numpy()})
            return grid, types.SimpleNamespace(loss=torch.tensor(0.5))
        return step

    monkeypatch.setattr(bench, "make_train_step", make_train_step)
    monkeypatch.setattr(bench, "make_optimizer", lambda params, cfg: None)
    monkeypatch.setattr(bench.renderer, "init", lambda gen, cfg, n, dev: {})
    seen = []
    res = bench.measure(bench.parse_args([*argv, "--device", "cpu"]), "cpu",
                        progress=lambda *a: seen.append(a))
    return cfgs[0], calls, res, seen


@pytest.mark.parametrize("arm", list(ARGVS))
def test_bench_setup_matches_the_script(arm, script, monkeypatch, capsys,
                                        tmp_path):
    jcfg, jcalls, jline = _script_run(script, monkeypatch, capsys, tmp_path,
                                      ARGVS[arm])
    tcfg, tcalls, (value, unit, iters), seen = _port_run(monkeypatch,
                                                         ARGVS[arm])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == bench.arm_config(bench.parse_args(ARGVS[arm]))
    assert unit == jline["unit"]
    assert iters == (10 if arm == "quick" else 50)
    # the warm-up, then every timed step
    assert len(tcalls) == len(jcalls) == iters + 1
    assert [c["step"] for c in tcalls] == [c["step"] for c in jcalls]
    assert tcalls[0]["step"] == bench.first_step(tcfg)
    for t, j in zip(tcalls, jcalls):
        for name in ("cam", "ij", "gt"):
            assert t[name].dtype == j[name].dtype, name
            np.testing.assert_array_equal(t[name], j[name])
    rays = tcfg.train.rays_per_step
    assert tcalls[0]["cam"].shape == (rays,)
    if tcfg.model.sampler_mode == "occ":
        assert jcalls[0]["grid"].dtype == np.float32
        np.testing.assert_array_equal(tcalls[0]["grid"], jcalls[0]["grid"])
        assert 0.2 < float((tcalls[0]["grid"][0] > 0).mean()) < 0.3
    for name in ("poses", "intr"):
        np.testing.assert_array_equal(tcalls[0][name], jcalls[0][name])
    jwarp = {k: np.asarray(v) for k, v in jcalls[0]["consts"]["field"].items()}
    twarp = {k: v.numpy() for k, v in tcalls[0]["consts"]["field"].items()}
    assert sorted(twarp) == sorted(jwarp)
    assert bool(twarp) == (arm == "warp")
    for k in jwarp:
        np.testing.assert_array_equal(twarp[k], jwarp[k])
    # the progress calls: the unit first, then one a chunk of 10
    assert seen[0] == (None, unit, 0)
    assert [s[2] for s in seen[1:]] == list(range(10, iters + 1, 10))
    assert seen[-1][0] == value > 0
    # the line for a given value
    for v in (0.0, 14200.0, 613224.37):
        monkeypatch.setattr(script, "_emitted", False)
        script._emit(v, unit)
        assert capsys.readouterr().out.strip() == bench.result_line(v, unit)


def test_bench_arm_key_names_the_device():
    args = bench.parse_args(["--dense", "--rays", "64"])
    assert bench.arm_key(args, "cpu") == (
        "quick=False,dense=True,warp=None,noqm=False,rays=64,chunk=None,"
        "device=cpu")


# -- the watchdog -------------------------------------------------------------

ARM = "quick=False,dense=False,warp=None,noqm=False,rays=None,chunk=None"
UNIT = "rays/s/chip (fwd+bwd+adam, occ sampler, 64 samples/ray)"
# branch: (best-so-far (value, iters) or None, cached (sha, arm) or None)
BRANCHES = {"best": ((512345.678, 30), ("sha", ARM)),
            "cache": (None, ("sha", ARM)),
            "wrong_sha": (None, ("other", ARM)),
            "wrong_arm": (None, ("sha", ARM + ",x")),
            "nothing": (None, None)}


class _Exit(Exception):
    pass


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_watchdog_matches_the_script(branch, script, monkeypatch, capsys,
                                     tmp_path):
    best, cached = BRANCHES[branch]
    cache = tmp_path / "BENCH_SELF.json"
    if cached is not None:
        cache.write_text(json.dumps({"value": 498765.4, "unit": UNIT,
                                     "iters": 50, "git_sha": cached[0],
                                     "arm": cached[1]}))

    def exit_(code):
        raise _Exit(code)

    monkeypatch.setattr(script.time, "sleep", lambda s: None)
    monkeypatch.setattr(script.os, "_exit", exit_)
    for mod in (script, bench):
        monkeypatch.setattr(mod, "_git_sha", lambda: "sha")
        monkeypatch.setattr(mod, "SELF_CACHE", cache)
    monkeypatch.setattr(script, "_emitted", False)
    monkeypatch.setattr(script, "_arm", {"key": ARM})
    monkeypatch.setattr(script, "_best", {
        "value": None if best is None else best[0], "unit": UNIT,
        "iters_done": 0 if best is None else best[1]})
    run = bench.BenchRun(ARM)
    run.progress(None, UNIT, 0)
    if best is not None:
        run.progress(*best[:1], UNIT, best[1])
    capsys.readouterr()
    lines = []
    for watchdog in (script._watchdog, run.watchdog):
        with pytest.raises(_Exit) as exc:
            watchdog(480.0)
        assert exc.value.args == (0,)
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    got = json.loads(lines[1])
    expect = {"best": "watchdog emit after 30 iters at 480s budget",
              "cache": "[CACHED in-round result",
              "wrong_sha": "exceeded budget", "wrong_arm": "exceeded budget",
              "nothing": "exceeded budget"}[branch]
    assert expect in got["unit"]
    assert got["value"] == {"best": 512345.7, "cache": 498765.4}.get(
        branch, 0.0)


# -- the CLI without jax, PIL or yaml -----------------------------------------

_SITE = """\
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "PIL", "yaml", "f2nerf_tpu")


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Block())
"""


def test_bench_cli_quick_without_jax(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(_SITE)
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}",
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "f2nerf_tpu_torch.bench", "--quick",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "device: cpu"
    assert [x.startswith("{") for x in lines] == [False, True]
    res = json.loads(lines[-1])
    assert list(res) == ["metric", "value", "unit", "vs_baseline"]
    assert res["metric"] == "train_rays_per_s_per_chip"
    assert res["unit"] == "rays/s/chip (tiny cfg)" and res["value"] > 0
    assert res["vs_baseline"] == round(res["value"] / 14200.0, 3)


def test_bench_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


# -- entry ---------------------------------------------------------------------

def test_entry_matches_the_script(occ_cfg, monkeypatch):
    """The script's ``entry`` jitted as its ``__main__`` does, against the
    port's on JAX's params and rays, both at ``occ_cfg``."""
    monkeypatch.setattr(jconfig, "Config", lambda: occ_cfg)
    tcfg = TConfig.from_dict(dataclasses.asdict(occ_cfg))
    monkeypatch.setattr(graft_entry, "Config", lambda: tcfg)
    script = _load("jax_graft_entry", "__graft_entry__.py")
    jfn, (jparams, jconsts, jo, jd, jbits) = script.entry()
    jcolors, jdepths = jax.jit(jfn)(jparams, jconsts, jo, jd, jbits)

    fn, (params, consts, rays_o, rays_d, bits) = graft_entry.entry("cpu")
    rays = tcfg.train.rays_per_step
    assert rays_o.shape == rays_d.shape == jo.shape == (rays, 3)
    assert bits.dtype == torch.bool
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert sorted(params) == sorted(jparams)
    colors, depths = fn(tree_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu"), consts,
                        torch.from_numpy(np.array(jo)),
                        torch.from_numpy(np.array(jd)), bits)
    assert colors.shape == (rays, 3) and depths.shape == (rays,)
    np.testing.assert_allclose(colors.numpy(), np.asarray(jcolors),
                               atol=ENTRY_TOL, rtol=0)
    np.testing.assert_allclose(depths.numpy(), np.asarray(jdepths),
                               atol=ENTRY_TOL, rtol=0)
    # the port's own rays: N(0, 1) x 0.1 and N(0, 1) + (0, 0, -1)
    own = fn(params, consts, rays_o, rays_d, bits)
    assert all(bool(torch.isfinite(x).all()) for x in own)
    assert abs(float(rays_d[:, 2].mean()) + 1.0) < 0.5


def test_entry_cli_prints_shapes(occ_cfg, monkeypatch, capsys):
    tcfg = TConfig.from_dict(dataclasses.asdict(occ_cfg))
    monkeypatch.setattr(graft_entry, "Config", lambda: tcfg)
    graft_entry.main(["--device", "cpu"])
    rays = tcfg.train.rays_per_step
    assert capsys.readouterr().out.strip() == (
        f"entry: OK [[{rays}, 3], [{rays}]]")


def test_graft_entry_cli_routes_the_dry_run(monkeypatch):
    """``dryrun N`` launches N ranks of itself, each given the same
    arguments (gloo without ``--device`` puts them on ``cuda:0``), and
    runs in place under torchrun's environment."""
    launched = []
    monkeypatch.setattr(graft_entry, "launch_ranks",
                        lambda module, n, argv: launched.append(
                            (module, n, [argv(r, 1234) for r in range(n)])))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    graft_entry.main(["dryrun", "2", "--device", "cpu"])
    graft_entry.main(["dryrun", "3", "--backend", "gloo"])
    graft_entry.main(["dryrun"])
    assert launched == [
        ("f2nerf_tpu_torch.graft_entry", 2,
         [["dryrun", "2", "--device", "cpu"]] * 2),
        ("f2nerf_tpu_torch.graft_entry", 3,
         [["dryrun", "3", "--device", "cuda:0", "--backend", "gloo"]] * 3),
        ("f2nerf_tpu_torch.graft_entry", 8, [["dryrun", "8"]] * 8)]
    ran = []
    monkeypatch.setattr(graft_entry, "dryrun_multichip",
                        lambda n, device=None, backend=None: ran.append(
                            (n, device, backend)))
    monkeypatch.setenv("WORLD_SIZE", "2")
    graft_entry.main(["dryrun", "2", "--device", "cpu", "--backend", "gloo"])
    assert ran == [(2, "cpu", "gloo")] and len(launched) == 3


def test_dryrun_needs_its_world_size():
    with pytest.raises(RuntimeError, match="need 2 ranks, have 1"):
        graft_entry.dryrun_multichip(2, device="cpu", arms=("dense",))
