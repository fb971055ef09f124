"""``f2nerf_tpu_torch/utils/trace.py``: spans and counters follow the
profiler (a shared no-op and nothing counted while it is off; a
``record_function`` range, a host duration and a total while it
records), the profiler window, and the renderer's spans and counter on
the CPU."""

import dataclasses
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.models import renderer
from f2nerf_tpu_torch.utils import trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_totals():
    trace.reset()
    yield
    trace.reset()


def _ranges(prof, name):
    return [e.time_range for e in prof.events()
            if e.name == name and e.is_user_annotation]


def test_off_is_one_shared_noop_and_counts_nothing():
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        trace.count("n", torch.ones(()))
        trace.count("n", 2)
    assert trace.host_durations() == {} and trace.counts() == {}


def test_on_records_ranges_durations_and_totals():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        with trace.span("outer") as outer:
            with trace.span("inner"):
                torch.ones(3) + 1
            trace.count("n", torch.tensor(2))
            trace.count("n", 3)
            trace.count("m", 1)
    assert outer.name == "outer"
    (o,), (i,) = _ranges(prof, "outer"), _ranges(prof, "inner")
    assert o.start <= i.start and i.end <= o.end
    seconds = trace.host_durations()
    assert len(seconds["outer"]) == len(seconds["inner"]) == 1
    assert seconds["outer"][0] >= seconds["inner"][0] > 0.0
    assert trace.counts() == {"n": 5.0, "m": 1.0}
    # the profiler closed: nothing more is kept
    with trace.span("outer"):
        trace.count("n", 1)
    assert len(trace.host_durations()["outer"]) == 1
    assert trace.counts()["n"] == 5.0
    trace.reset()
    assert trace.host_durations() == {} and trace.counts() == {}


def test_window_writes_one_chrome_trace_of_its_units(tmp_path):
    w = trace.Window(tmp_path / "prof", (1, 3), "units", "_rank1")
    on = []
    for unit in range(5):
        w.tick(unit, CPU)
        on.append(trace.enabled())
        with trace.span("unit"):
            torch.ones(2) * 2
    assert on == [False, True, True, False, False]
    files = sorted(p.name for p in (tmp_path / "prof").iterdir())
    assert files == ["units_1_3_rank1.json"]
    events = json.loads((tmp_path / "prof" / files[0]).read_text())
    assert sum(e.get("name") == "unit" and e.get("cat") == "user_annotation"
               for e in events["traceEvents"]) == 2


def test_window_closes_only_on_its_own_thread(tmp_path):
    w = trace.Window(tmp_path, (0, 1), "units")
    w.tick(0, CPU)
    other = threading.Thread(target=w.tick, args=(1, CPU))
    other.start()
    other.join(timeout=60)
    assert not other.is_alive()
    assert trace.enabled() and not w.path.exists()
    w.tick(1, CPU)
    assert not trace.enabled() and w.path.exists()


def test_no_folder_no_window(tmp_path):
    w = trace.Window(None, (0, 1), "units")
    w.tick(0, CPU)
    assert not trace.enabled() and w.path is None


def _render(cfg):
    gen = torch.Generator().manual_seed(0)
    params = renderer.init(gen, cfg, 2, CPU)
    rays_o = torch.zeros(16, 3)
    rays_o[:, 2] = 1.5
    rays_d = torch.nn.functional.normalize(
        torch.randn(16, 3, generator=gen) * 0.2
        + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    return renderer.render(params, rays_o, rays_d, cfg)


def test_render_spans_and_its_live_share(tiny_cfg):
    cfg = TConfig.from_dict(dataclasses.asdict(tiny_cfg)).model
    _render(cfg)
    assert trace.host_durations() == {} and trace.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _render(cfg)
    for name in ("render.sample", "render.field", "render.shade",
                 "render.composite"):
        assert len(_ranges(prof, name)) == 1, name
    live = float(((res.dt > 0) & res.mask).sum())
    assert trace.counts() == {"render.live": live,
                              "render.slots": float(res.dt.numel())}
    assert 0 < live <= res.dt.numel()
