"""The train step's CUDA graphs (``train/step_graph.py``).

On the CPU: where the graphs engage (``step.graphable``) and that every
other case keeps the eager step; the graph key; the counters and
kernel launches a capture records and each replay adds; the lr
tensor of a capturable optimizer; and the whole graph path with a
stand-in for ``torch.cuda.CUDAGraph`` whose replay runs the captured
work again, bitwise against the eager step.

On the card (marker ``cuda``; the module imports neither JAX nor the JAX
package, so it runs there as
``python -m pytest --noconftest tests/test_torch_step_graph.py -q``):
graphed and eager steps of each benchmark configuration agree bit for
bit over every refresh phase, the variance-loss ramp crossed inside the
graphs, and stay within the cells' limits of the CPU's Adam arithmetic;
the kernels' launch counters and the counters match the eager step's; a
no-op optimizer leaves the params as they were.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from f2nerf_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from f2nerf_tpu_torch.kernels import trilinear
from f2nerf_tpu_torch.models import renderer
from f2nerf_tpu_torch.parallel.mesh import DataMesh
from f2nerf_tpu_torch.train import optim as topt
from f2nerf_tpu_torch.train import step as tstep
from f2nerf_tpu_torch.train import step_graph
from f2nerf_tpu_torch.utils import trace

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
N_IMAGES = 4


def _cfg(sampler="occ", **train):
    model = ModelConfig(
        n_levels=2, n_channels=2, log2_table_size=10, n_samples=32,
        sample_l=1.0 / 8.0, bf16_features=False, sampler_mode=sampler,
        encode_chunk=65536, occ_grid_res=16, occ_segments=16, occ_keep=4,
        occ_samples_per_segment=2, occ_update_every=4)
    tr = dict(pts_batch_size=16384, end_iter=40, report_freq=20,
              vis_freq=10 ** 9, save_freq=10 ** 9,
              learning_rate_warm_up_end_iter=10, var_loss_start=10,
              var_loss_end=20)
    tr.update(train)
    return Config(model=model, train=TrainConfig(**tr))


def _setup(cfg, seed, device, n_batches):
    """Params with O(1) features, cameras, batches and a grid whose mean
    channel cuts rays."""
    gen = torch.Generator().manual_seed(seed)
    params = renderer.init(gen, cfg.model, N_IMAGES, CPU)
    rng = np.random.default_rng(seed)
    pool = params["field"]["feat_pool"]
    params["field"]["feat_pool"] = torch.as_tensor(
        rng.uniform(-1.0, 1.0, tuple(pool.shape)).astype(np.float32))
    params["field"]["mlp"]["b"][0] = 2.0
    poses = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_IMAGES, 1, 1))
    poses[:, :, 3] = rng.uniform(-0.3, 0.3, (N_IMAGES, 3))
    intr = np.tile(np.array([[12.0, 0, 8], [0, 12.0, 8], [0, 0, 1]],
                            np.float32)[None], (N_IMAGES, 1, 1))
    r = cfg.train.rays_per_step
    batches = [(rng.integers(0, N_IMAGES, r).astype(np.int32),
                rng.integers(0, 16, (r, 2)).astype(np.int32),
                rng.random((r, 3)).astype(np.float32))
               for _ in range(n_batches)]
    g = cfg.model.occ_grid_res
    thresh = 0.5
    occ = (rng.random((g, g, g)) < 0.25).astype(np.float32)
    grid = np.stack([occ * 2 * thresh, occ * 2e3])
    return dict(params=params, poses=poses, intr=intr, batches=batches,
                grid=grid if cfg.model.sampler_mode == "occ" else None,
                device=device)


def _fresh(s):
    """A copy of the setup's state on its device: params, optimizer
    inputs, grid."""
    dev = s["device"]

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v.clone().to(dev)
                for k, v in tree.items()}

    grid = None if s["grid"] is None else torch.tensor(s["grid"], device=dev)
    return (copy(s["params"]), torch.tensor(s["poses"], device=dev),
            torch.tensor(s["intr"], device=dev), grid)


def _steps(cfg, s, step0, n, how="graphed", opt_hook=None, consts=None):
    """n steps from step0 of a fresh copy of the setup; per step the
    metrics (kept as returned) and the grid returned, then the params."""
    params, poses, intr, grid = _fresh(s)
    opt = topt.make_optimizer(params, cfg.train)
    opt.set_count(step0)
    if opt_hook is not None:
        opt_hook(opt)
    step_fn = tstep.make_train_step(cfg, opt)
    fn = step_fn if how == "graphed" else step_fn.eager
    dev = s["device"]
    metrics, grids = [], []
    counted = step_graph._COUNTED
    launches0 = [f.launches for f in counted]
    for k in range(n):
        cam, ij, gt = s["batches"][k % len(s["batches"])]
        grid, m = fn(params, grid, poses, intr, step0 + k,
                     torch.tensor(cam, device=dev),
                     torch.tensor(ij, device=dev),
                     torch.tensor(gt, device=dev), consts=consts)
        metrics.append(m)
        grids.append(grid)
    return dict(metrics=metrics, grids=grids, opt=opt,
                params={k: p.detach().clone() for k, p in opt.named.items()},
                step_fn=step_fn,
                launches=[f.launches - n0 for f, n0 in zip(counted,
                                                           launches0)])


def _equal_runs(a, b):
    for k, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        for x, y in zip(ma, mb):
            assert torch.equal(x, y), k
    for k, (ga, gb) in enumerate(zip(a["grids"], b["grids"])):
        assert (ga is None and gb is None) or torch.equal(ga, gb), k
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


# -- where the graphs engage ---------------------------------------------------

def test_graphable_only_on_cuda_without_mesh_blocks_or_two_pass():
    cuda = torch.device("cuda")
    occ, dense = _cfg("occ"), _cfg("dense")
    assert tstep.graphable(occ, None, cuda)
    assert tstep.graphable(dense, None, cuda)
    assert not tstep.graphable(occ, None, CPU)
    mesh = DataMesh(rank=0, size=1, device=cuda, group=None)
    assert not tstep.graphable(occ, mesh, cuda)
    blocks = dataclasses.replace(
        occ, train=dataclasses.replace(occ.train, grad_blocks=2))
    assert not tstep.graphable(blocks, None, cuda)
    two_pass = dataclasses.replace(dense, model=dataclasses.replace(
        dense.model, dense_two_pass=True))
    assert not tstep.graphable(two_pass, None, cuda)
    # the occupancy sampler never takes the two-pass render
    occ_flag = dataclasses.replace(occ, model=dataclasses.replace(
        occ.model, dense_two_pass=True))
    assert tstep.graphable(occ_flag, None, cuda)


@pytest.mark.parametrize("case", ["occ", "dense", "blocks", "two_pass"])
def test_cpu_and_the_excluded_paths_stay_eager_and_bitwise(case,
                                                           monkeypatch):
    """On the CPU the step never builds graphs, and what it returns is
    the eager step's, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("graphs engaged on the CPU")

    monkeypatch.setattr(step_graph, "StepGraphs", refuse)
    cfg = _cfg("dense" if case in ("dense", "two_pass") else "occ")
    if case == "blocks":
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, grad_blocks=2))
    if case == "two_pass":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dense_two_pass=True))
    s = _setup(cfg, 3, CPU, 3)
    a = _steps(cfg, s, 600, 3, "graphed")
    b = _steps(cfg, s, 600, 3, "eager")
    for ma, mb in zip(a["metrics"], b["metrics"]):
        for x, y in zip(ma, mb):
            assert torch.equal(x, y)
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


# -- a stand-in for the card's graphs -------------------------------------------

def _in_place(held, new, value) -> None:
    """What a replay recorded, written into what the first replay
    recorded: a graph's outputs keep their addresses."""
    if held is None:
        return
    if not held:
        held.extend(new)
        return
    for a, b in zip(held, new):
        if torch.is_tensor(value(a)):
            value(a).copy_(value(b))


class _Replayed:
    """Runs the captured work at each replay, with or without the
    counters as it was captured, and writes what they record into the
    capture's list in place, as a CUDA graph's replay recomputes its
    outputs at fixed addresses; the optimizer sees a capture
    (``optim._capturing``), which leaves the count to the step."""

    capturing = False

    def __init__(self, work, log):
        self.work, self.log = work, log
        # the capture's own list (None: captured without)
        self.pairs = trace._pairs

    def replay(self):
        self.log.append(self)
        _Replayed.capturing = True
        try:
            with trace.capturing(self.pairs is not None) as pairs:
                self.work()
        finally:
            _Replayed.capturing = False
        _in_place(self.pairs, pairs, lambda pair: pair[1])


@pytest.fixture
def stand_in(monkeypatch):
    """Graphs on the CPU: ``graphable`` true, captures stood in for by
    :class:`_Replayed`; yields the log of captures and replays."""
    log = {"captures": [], "replays": []}

    def capture(self, work):
        g = _Replayed(work, log["replays"])
        log["captures"].append(g)
        return g

    monkeypatch.setattr(tstep, "graphable", lambda cfg, mesh, dev: True)
    monkeypatch.setattr(topt, "_capturing", lambda t: _Replayed.capturing)
    monkeypatch.setattr(step_graph.StepGraphs, "_capture", capture)
    return log


def _capturable_cpu(monkeypatch):
    """From here on, Adam built as on a CUDA device (a tensor lr, bias
    corrections in float32), on the CPU."""
    from torch.optim import adam
    devices = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*devices(*a, **k), "cpu"])
    monkeypatch.setattr(topt, "_capturable", lambda dev: True)


@pytest.mark.parametrize("sampler", ["occ", "dense"])
def test_stand_in_graphs_match_the_eager_step_bitwise(sampler, stand_in):
    """Buffers, draws, weights, grid hand-over and metrics: the graph
    path gives the eager step's numbers bit for bit over every refresh
    phase and across the variance-loss ramp (steps 8-22, ramp 10-20)."""
    cfg = _cfg(sampler)
    s = _setup(cfg, 5, CPU, 4)
    n = 15
    g = _steps(cfg, s, 8, n, "graphed")
    e = _steps(cfg, s, 8, n, "eager")
    phases = cfg.model.occ_refresh_phases if sampler == "occ" else 0
    # one family: per refresh phase and one without a refresh, a graph
    # without the counters and one with them
    assert len(stand_in["captures"]) == 2 * (phases + 1)
    assert len(stand_in["replays"]) == n - 1
    for k, (mg, me) in enumerate(zip(g["metrics"], e["metrics"])):
        for x, y in zip(mg, me):
            assert torch.equal(x, y), k
    for k in e["params"]:
        assert torch.equal(g["params"][k], e["params"][k]), k
    for k, (a, b) in enumerate(zip(g["grids"], e["grids"])):
        assert (a is None and b is None) or torch.equal(a, b), k
    assert g["opt"].count == e["opt"].count == 8 + n


def test_stand_in_with_capturable_adam(stand_in, monkeypatch):
    """Adam as on the card (a tensor lr, bias corrections in float32):
    bitwise the eager step with the same Adam; against the CPU's Adam
    the first loss is bitwise, the rest within rounding."""
    cfg = _cfg("occ")
    s = _setup(cfg, 6, CPU, 4)
    e = _steps(cfg, s, 30, 6, "eager")
    _capturable_cpu(monkeypatch)
    g = _steps(cfg, s, 30, 6)
    c = _steps(cfg, s, 30, 6, "eager")
    _equal_runs(g, c)
    assert torch.equal(g["metrics"][0].loss, e["metrics"][0].loss)
    for mg, me in zip(g["metrics"], e["metrics"]):
        torch.testing.assert_close(mg.loss, me.loss, rtol=1e-5, atol=0)
    for k in e["params"]:
        torch.testing.assert_close(g["params"][k], e["params"][k],
                                   rtol=1e-4, atol=1e-6)
    assert g["opt"].adam.param_groups[0]["capturable"]


def test_graph_key_phase_and_half_batch(stand_in):
    """A refresh step replays its phase's graph; a half batch is a new
    family, captured anew."""
    cfg = _cfg("occ")
    s = _setup(cfg, 7, CPU, 2)
    params, poses, intr, grid = _fresh(s)
    opt = topt.make_optimizer(params, cfg.train)
    step_fn = tstep.make_train_step(cfg, opt)
    replays = stand_in["replays"]

    def run(step, rows):
        nonlocal grid
        cam, ij, gt = (torch.tensor(x[:rows]) for x in s["batches"][0])
        grid, _ = step_fn(params, grid, poses, intr, step, cam, ij, gt)

    # past occ_refresh_warmup: a refresh every occ_update_every steps
    run(3001, 16)                     # eager: the first step
    assert not stand_in["captures"]
    run(3002, 16)                     # captures the family, replays None
    family = stand_in["captures"][:]
    assert len(family) == 2 * (cfg.model.occ_refresh_phases + 1)
    run(3003, 16)
    assert replays[-1] is replays[-2]
    run(3004, 16)                     # a refresh step: another graph
    assert tstep.refresh_phase(cfg, 3004) is not None
    assert replays[-1] is not replays[-2] and replays[-1] in family
    run(3005, 8)                      # half the batch: a new family
    assert len(stand_in["captures"]) == 2 * len(family)
    assert replays[-1] not in family


def test_returned_grid_and_metrics_keep_their_values(stand_in):
    """A grid returned at a refresh and the metrics of each step are
    the caller's: later replays leave them as they were."""
    cfg = _cfg("occ")
    s = _setup(cfg, 8, CPU, 3)
    g = _steps(cfg, s, 40, 10)
    snapshot = [m.loss.clone() for m in g["metrics"]]
    refreshed = [k for k in range(10) if tstep.refresh_phase(cfg, 40 + k)
                 is not None and k > 0]
    held = {k: g["grids"][k].clone() for k in refreshed}
    # more replays
    e = _steps(cfg, s, 40, 10, "eager")
    for k, m in enumerate(g["metrics"]):
        assert torch.equal(m.loss, snapshot[k])
    for k in refreshed:
        assert torch.equal(g["grids"][k], held[k])
        assert g["grids"][k] is not g["grids"][k - 1]
    assert e["metrics"][0].loss.shape == ()


def test_no_op_optimizer_leaves_params(stand_in):
    """The harness's planted fault: ``optimizer.step`` a no-op before
    the first call; the graphs take the no-op."""
    cfg = _cfg("occ")
    s = _setup(cfg, 9, CPU, 3)

    def no_op(opt):
        opt.step = lambda: None

    g = _steps(cfg, s, 40, 6, opt_hook=no_op)
    assert not any(g["opt"].adam.state.values())
    params0, *_ = _fresh(s)
    from f2nerf_tpu_torch.convert import flatten
    for k, p in flatten(params0).items():
        assert torch.equal(g["params"][k], p), k
    assert len(stand_in["replays"]) == 5


def test_counters_recorded_at_capture_and_added_after_replay(stand_in):
    """While profiled, a graphed step adds the renderer's counters as the
    eager step does, and counts itself in step.graphed."""
    from torch.profiler import ProfilerActivity, profile
    cfg = _cfg("occ")
    s = _setup(cfg, 10, CPU, 2)
    trace.reset()
    try:
        for how in ("eager", "graphed"):
            params, poses, intr, grid = _fresh(s)
            opt = topt.make_optimizer(params, cfg.train)
            step_fn = tstep.make_train_step(cfg, opt)
            fn = step_fn.eager if how == "eager" else step_fn
            cam, ij, gt = (torch.tensor(x) for x in s["batches"][0])
            fn(params, grid, poses, intr, 41, cam, ij, gt)
            with profile(activities=[ProfilerActivity.CPU]):
                fn(params, grid, poses, intr, 42, cam, ij, gt)
                fn(params, grid, poses, intr, 43, cam, ij, gt)
            totals = trace.counts()
            spans = trace.host_durations()
            trace.reset()
            if how == "eager":
                eager, eager_spans = totals, spans
        assert totals.pop("step.graphed") == 2.0
        assert totals == eager and eager["render.slots"] > 0
        assert "step.replay" in spans
        assert "step.forward" in eager_spans
    finally:
        trace.reset()


def test_untraced_replays_run_no_counter_work(stand_in):
    """Outside a profiler the step replays the graphs captured without
    the counters, whose capture recorded nothing."""
    cfg = _cfg("occ")
    s = _setup(cfg, 10, CPU, 2)
    _steps(cfg, s, 41, 4)
    replays = stand_in["replays"]
    assert len(replays) == 3
    assert all(g.pairs is None for g in replays)
    traced = [g for g in stand_in["captures"] if g.pairs is not None]
    assert len(traced) == len(stand_in["captures"]) // 2


def test_kernel_launches_count_replays_not_captures(stand_in, monkeypatch):
    """A kernel wrapper's launch counter ticks once for each launch: the
    ticks of a capture (which launches nothing) are taken back and added
    at each replay of its graph."""
    capture = step_graph.StepGraphs._capture

    def ticking(self, work):
        trilinear.trilinear_fwd.launches += 3
        trilinear.trilinear_bwd.launches += 1
        trilinear.page_index.launches += 3
        return capture(self, work)

    monkeypatch.setattr(step_graph.StepGraphs, "_capture", ticking)
    monkeypatch.setattr(trilinear.trilinear_fwd, "launches", 0)
    monkeypatch.setattr(trilinear.trilinear_bwd, "launches", 0)
    monkeypatch.setattr(trilinear.page_index, "launches", 0)
    cfg = _cfg("occ")
    s = _setup(cfg, 12, CPU, 2)
    _steps(cfg, s, 41, 6)
    assert len(stand_in["replays"]) == 5
    assert trilinear.trilinear_fwd.launches == 15
    assert trilinear.trilinear_bwd.launches == 5
    assert trilinear.page_index.launches == 15


def test_capturing_records_pairs_or_nothing():
    trace.reset()
    assert not trace.enabled()
    value = torch.tensor(3)
    with trace.capturing(True) as pairs:
        assert trace.enabled()
        assert trace.span("x") is trace.span("y")       # the no-op
        trace.count("a", value)
        trace.count("b", 2)
    assert not trace.enabled()
    assert pairs == [("a", value), ("b", 2)]
    assert trace.counts() == {}
    trace.add(pairs)                   # no profiler: nothing added
    assert trace.counts() == {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.capturing(False) as none:
            assert none is None and not trace.enabled()
            assert trace.span("x") is trace.span("y")
            trace.count("a", 100)
        assert trace.enabled()
        trace.add(pairs)
        value.fill_(5)                 # the next replay's output
        trace.add(pairs)
    assert trace.counts() == {"a": 8.0, "b": 4.0}
    trace.reset()


@pytest.mark.parametrize("count", [0, 1, 5, 9, 10, 11, 25, 40, 55])
def test_capturable_lr_tensor_follows_the_schedule(count, monkeypatch):
    """Adam as on a CUDA device: one lr tensor in every group, written
    by set_count and advance with learning_rate * lr_factor(count); a
    checkpoint keeps the CPU's form, and loading it back restores the
    device's."""
    cfg = _cfg("occ")
    p = {"field": {"feat_pool": torch.ones(2, 2), "mlp": {"w": torch.ones(3)}}}
    eager = topt.make_optimizer(p, cfg.train)
    eager.set_count(count)
    _capturable_cpu(monkeypatch)
    opt = topt.make_optimizer(p, cfg.train)
    opt.set_count(count)
    lr = opt.adam.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and opt.capturable
    assert all(g["lr"] is lr and g["capturable"]
               for g in opt.adam.param_groups)
    want = cfg.train.learning_rate * topt.lr_factor(cfg.train, count)
    assert eager.adam.param_groups[0]["lr"] == want == opt.lr()
    assert lr.item() == np.float32(want)
    opt.advance()
    assert lr.item() == np.float32(cfg.train.learning_rate
                                   * topt.lr_factor(cfg.train, count + 1))
    opt.set_count(count)
    assert lr.item() == np.float32(want)
    for q in opt.named.values():
        q.grad = torch.ones_like(q)
    opt.step()
    opt.set_count(count)
    # the state a checkpoint keeps is the CPU's form
    sd = opt.state_dict()
    assert [g["lr"] for g in sd["param_groups"]] == [want, want]
    assert not any(g["capturable"] for g in sd["param_groups"])
    assert all(st["step"].device.type == "cpu" for st in sd["state"].values())
    assert opt.adam.param_groups[0]["lr"] is lr
    opt.load_state_dict(sd)
    assert all(g["lr"] is lr and g["capturable"]
               for g in opt.adam.param_groups)
    assert lr.item() == np.float32(want)
    eager.load_state_dict(sd)
    assert eager.adam.param_groups[0]["lr"] == want
    assert not eager.adam.param_groups[0]["capturable"]


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")


def _cell(name):
    from portbench import harness
    return harness.load_cell(ROOT, name)


def _cell_setup(name, dev, seed=20260):
    """The benchmark cell's own set-up (``portbench/drive_train.py``):
    config, weights, constants, cameras, grid and batches from ``seed``."""
    from portbench import inputs
    from portbench.reference import field as F
    cell = _cell(name)
    cfg = Config.from_dict(cell.config["config"])
    model = F.model_ns(cell.config["config"]["model"])
    mix = cell.mix
    s = inputs.sub_seeds(seed, ("weights", "grid", "batches"))
    scene = cell.field.train_scene(model, mix, s["weights"], dev)
    grid = (inputs.seeded_grid(model, s["grid"], dev)
            if model.sampler_mode == "occ" else None)
    rng = np.random.default_rng(s["batches"])
    batches = [inputs.batch_data(rng, cfg.train.rays_per_step,
                                 int(mix["images"]), int(mix["image_hw"]))
               for _ in range(8)]
    return cell, cfg, dict(
        params=_cpu(scene.params),
        poses=scene.poses.cpu().numpy(), intr=scene.intr.cpu().numpy(),
        batches=batches,
        grid=None if grid is None else grid.cpu().numpy(), device=dev,
        consts={"field": scene.consts})


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.detach().cpu()
            for k, v in tree.items()}


def _gaps(g, e, p0, n):
    """The cells' gap measures (``portbench/checks.train_numbers``) of a
    graphed run ``g`` from an eager run ``e`` over their first ``n``
    steps: loss, the params' change, the grid after the first step."""
    loss = max(abs(float(a.loss) - float(b.loss)) / abs(float(b.loss))
               for a, b in zip(g["metrics"][:n], e["metrics"][:n]))

    def norms(run):
        return {k: float(torch.linalg.vector_norm(
            run["params"][k].double().cpu() - p0[k].double())) for k in p0}

    cg, ce = norms(g), norms(e)
    med = float(np.median(list(ce.values())))
    change = max(abs(cg[k] - ce[k]) / max(ce[k], med) for k in ce)
    out = {"loss_gap": loss, "change_gap": change}
    if e["grids"][0] is not None:
        a, b = g["grids"][0].double(), e["grids"][0].double()
        out["grid_gap"] = float(torch.max(
            torch.abs(a - b) / torch.clamp_min(torch.abs(b), 1e-9)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,step0,n", [
    ("occ-train", 3072, 52), ("persp-train", 3072, 52),
    ("dense-train", 3072, 40), ("dense-train", 4990, 40),
    ("occ-train", 508, 10)])
def test_card_graphs_replay_the_eager_step(name, step0, n, cuda,
                                           monkeypatch):
    """Over every refresh phase (steps 3072-3123 refresh at 3072, 3088,
    3104 and 3120), across the variance-loss ramp (from step 5000) or
    across the end of the occupancy warm-up (step 512: a new family):
    the graphed run is bit for bit the eager step, in every step's
    metrics (read after the last step), every grid returned and the
    params, and counts the same kernel launches. Against the CPU's Adam
    arithmetic (float64 bias corrections) run on the card the first loss
    is bitwise and the cell's checked steps (the first three) are within
    its limits."""
    from f2nerf_tpu_torch.convert import flatten
    cell, cfg, s = _cell_setup(name, cuda)
    p0 = flatten(s["params"])
    g = _steps(cfg, s, step0, n, consts=s["consts"])
    c = _steps(cfg, s, step0, n, "eager", consts=s["consts"])
    _equal_runs(g, c)
    assert g["opt"].adam.param_groups[0]["capturable"]
    assert g["launches"] == c["launches"] and min(g["launches"][:2]) >= n
    # one index launch for each encode, replays included
    assert g["launches"][3] == g["launches"][0]
    g3 = _steps(cfg, s, step0, 3, consts=s["consts"])
    monkeypatch.setattr(topt, "_capturable", lambda dev: False)
    e3 = _steps(cfg, s, step0, 3, "eager", consts=s["consts"])
    assert not e3["opt"].adam.param_groups[0]["capturable"]
    assert torch.equal(g3["metrics"][0].loss, e3["metrics"][0].loss)
    gaps = _gaps(g3, e3, p0, 3)
    print(name, step0, gaps)
    for key, value in gaps.items():
        assert value <= cell.limits[key], (key, value, cell.limits[key])


@pytest.mark.cuda
def test_card_no_op_optimizer_leaves_the_params(cuda):
    """The harness's planted fault on the card: ``optimizer.step`` a
    no-op before the first call; the graphs capture the no-op."""
    from f2nerf_tpu_torch.convert import flatten
    cell, cfg, s = _cell_setup("occ-train", cuda)

    def no_op(opt):
        opt.step = lambda: None

    f = _steps(cfg, s, 3085, 6, opt_hook=no_op, consts=s["consts"])
    for key, p in flatten(s["params"]).items():
        assert torch.equal(f["params"][key].cpu(), p), key
