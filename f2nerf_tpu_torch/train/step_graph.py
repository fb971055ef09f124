"""The train step's device work replayed from CUDA graphs
(``make_train_step`` engages them where ``step.graphable`` holds).

A step's device work, the refresh, the occupancy values, the forward,
the backward and Adam's update, is about a thousand launches from the
host. Captured once as a ``torch.cuda.CUDAGraph`` it is one launch a
step, of the same kernels in the same order.

A capture bakes in what the host decided and where every tensor lives.
The graphs of one *family* share all of it: the batch's shapes, which
draws the step has, the occupancy warm-up, whether levels anneal, and
the addresses of the tensors a replay reads or updates in place (the
params, their grads and Adam's state, the poses, the intrinsics and the
constants). A family holds two graphs per refresh phase (None, 0 ..
K-1), one without the program's counters and one with them, all
captured when the family first comes, so that no capture falls among
the steps that follow; a new family replaces the old one.

Before each replay the step writes what changes from step to step into
the family's buffers: the batch (copied), the draws (drawn in place from
the step's own generator, bit for bit :func:`step.draw_noise`'s, or
copied from the caller's), the lr (the optimizer's device scalar), the
variance-loss weight, the level weights, and the grid where the caller
hands one the buffer does not hold yet. A replay leaves its metrics and
its refreshed grid in buffers that the next replay overwrites, so the
step returns copies of them. The grads are allocated once and zeroed
inside the graph; the backward adds into them.

The graphs of a family share one memory pool: they never run at once,
and what a caller keeps is copied out of the pool right after its
replay.

Counters: a graph runs the counters' device work only where it was
captured with them. The step replays the graph without them unless a
profiler records (``trace.enabled``). A capture records each
``trace.count`` pair (``trace.capturing``); after a replay the step adds
copies of them to the totals, and ``step.graphed`` counts the step
while a profiler records. The kernel wrappers' launch counters
(``trilinear_*.launches``, ``page_index.launches``) tick during a
capture, which launches nothing, and not during a replay, which does:
the capture puts them back and keeps the ticks, and each replay adds
them. The eager step's
inner spans time host work that a replay does not do:
``step.replay`` times the launch.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from f2nerf_tpu_torch.convert import flatten
from f2nerf_tpu_torch.kernels import trilinear
from f2nerf_tpu_torch.models import occupancy
from f2nerf_tpu_torch.train.optim import Optimizer
from f2nerf_tpu_torch.train.step import (StepMetrics, StepNoise, StepPlan,
                                         draw_noise, level_weights,
                                         refresh_phase, var_loss_weight)
from f2nerf_tpu_torch.utils import trace

# the kernels whose wrappers count their launches
_COUNTED = (trilinear.trilinear_fwd, trilinear.trilinear_bwd,
            trilinear.trilinear_bwd_frac, trilinear.page_index)


class _Graph(NamedTuple):
    """A captured graph and what its replays recompute for the
    counters: ``trace.count`` pairs (None where captured without them)
    and the counted kernels' launches."""
    graph: Any
    pairs: list | None
    launches: tuple[int, ...]


class _Buffers(NamedTuple):
    """A family's inputs and outputs, at fixed addresses."""
    cam_idx: torch.Tensor
    ij: torch.Tensor
    gt: torch.Tensor
    noise: StepNoise            # refresh None: see ``refresh``
    refresh: torch.Tensor | None
    var_w: torch.Tensor         # 0-d
    level_w: torch.Tensor | None
    grid: torch.Tensor | None
    metrics: torch.Tensor       # [5], StepMetrics' order


def _spec(t: torch.Tensor | None):
    return None if t is None else (tuple(t.shape), t.dtype)


def _where(t: torch.Tensor):
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


class StepGraphs:
    """The CUDA graphs of one step function (module docstring).
    ``device_work`` is the step's own, as ``make_train_step`` runs it
    eagerly."""

    def __init__(self, cfg, optimizer: Optimizer, device_work):
        self.cfg = cfg
        self.optimizer = optimizer
        self.device_work = device_work
        self.family = None
        self.graphs: dict = {}        # (refresh phase, counters) -> _Graph
        self.buf: _Buffers | None = None
        self._bound = None            # what the family's work reads
        self.pool = None
        self._held = None             # (grid, its version) buf.grid holds
        self._var_w = None            # the weight buf.var_w holds

    def serves(self, params: dict[str, Any]) -> bool:
        """Whether ``params``' leaves are the optimizer's, which the
        graphs update."""
        leaves = flatten(params).values()
        return ({id(p) for p in leaves}
                == {id(p) for p in self.optimizer.named.values()})

    def step(self, params, occ_grid, poses, intrinsics, step: int, cam_idx,
             ij, gt, noise: StepNoise | None, consts
             ) -> tuple[torch.Tensor | None, StepMetrics]:
        cfg, opt = self.cfg, self.optimizer
        for p in opt.named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        phase = refresh_phase(cfg, step)
        warmup = step < cfg.model.occ_warmup_steps
        lw = level_weights(cfg, step)
        if noise is not None and phase is not None and noise.refresh is None:
            raise ValueError(f"step {step} refreshes the grid: its noise "
                             f"needs the refresh draws")
        family = self._family(occ_grid, poses, intrinsics, cam_idx, ij, gt,
                              noise, consts, warmup, lw is None)
        if family != self.family:
            self._capture_family(family, params, occ_grid, poses, intrinsics,
                                 step, cam_idx, ij, gt, noise, consts,
                                 warmup, lw)
        b = self.buf
        with trace.span("step.noise"):
            if noise is None:
                draw_noise(cfg, step, cam_idx.shape[0], poses.device,
                           into=b.noise._replace(refresh=b.refresh))
            else:
                for name, x in zip(noise._fields, noise):
                    if x is not None and (name != "refresh"
                                          or phase is not None):
                        (b.refresh if name == "refresh"
                         else getattr(b.noise, name)).copy_(x)
        for dst, src in ((b.cam_idx, cam_idx), (b.ij, ij), (b.gt, gt)):
            dst.copy_(src)
        var_w = var_loss_weight(step, cfg)
        if var_w != self._var_w:
            b.var_w.fill_(var_w)
            self._var_w = var_w
        if lw is not None:
            # pageable and small: CUDA stages it before the call returns
            b.level_w.copy_(torch.from_numpy(lw), non_blocking=True)
        if occ_grid is not None and not self._holds(occ_grid):
            b.grid.copy_(occ_grid)
            self._held = (occ_grid, occ_grid._version)
        g = self._graph(phase, trace.enabled())
        with trace.span("step.replay"):
            g.graph.replay()
        opt.advance()
        for fn, n in zip(_COUNTED, g.launches):
            fn.launches += n
        metrics = b.metrics.clone()
        if phase is not None:
            occ_grid = b.grid.clone()
            self._held = (occ_grid, occ_grid._version)
        if g.pairs is not None:
            trace.add(g.pairs)
        trace.count("step.graphed", 1)
        return occ_grid, StepMetrics(*metrics.unbind())

    def _holds(self, grid: torch.Tensor) -> bool:
        """Whether buf.grid holds ``grid``'s values: it is the grid last
        copied in or handed out, unchanged since (its version)."""
        return (self._held is not None and grid is self._held[0]
                and grid._version == self._held[1])

    def _family(self, occ_grid, poses, intrinsics, cam_idx, ij, gt, noise,
                consts, warmup: bool, no_anneal: bool) -> tuple:
        """What the captures bake in (module docstring), as a key."""
        opt = self.optimizer
        state = tuple(t.data_ptr() for p in opt.named.values()
                      for t in (p, p.grad, *opt.adam.state[p].values()))
        fixed = [poses, intrinsics, *(t for t in flatten(consts or {})
                                      .values() if torch.is_tensor(t))]
        return (tuple(_spec(t) for t in (cam_idx, ij, gt, occ_grid)),
                None if noise is None else tuple(_spec(x) for x in noise[1:]),
                warmup, no_anneal, tuple(_where(t) for t in fixed), state)

    def _capture_family(self, family, params, occ_grid, poses, intrinsics,
                        step, cam_idx, ij, gt, noise, consts, warmup, lw):
        cfg = self.cfg
        dev = poses.device
        # a pool whose graphs are all gone cannot take a capture again:
        # each family gets its own
        self.graphs, self.pool = {}, None
        drawn = (noise if noise is not None
                 else draw_noise(cfg, step, cam_idx.shape[0], dev))
        use_occ = cfg.model.sampler_mode == "occ"
        self.buf = _Buffers(
            cam_idx=torch.empty_like(cam_idx), ij=torch.empty_like(ij),
            gt=torch.empty_like(gt),
            noise=StepNoise(refresh=None, **{
                name: None if x is None else torch.empty_like(x)
                for name, x in zip(drawn._fields[1:], drawn[1:])}),
            refresh=(torch.empty((occupancy.refresh_points(cfg.model), 3),
                                 device=dev) if use_occ else None),
            var_w=torch.zeros((), device=dev),
            level_w=(None if lw is None
                     else torch.empty(lw.shape, device=dev)),
            grid=None if occ_grid is None else torch.empty_like(occ_grid),
            metrics=torch.empty(len(StepMetrics._fields), device=dev))
        self._held = self._var_w = None
        self._bound = (params, poses, intrinsics, consts, warmup)
        phases = ([None, *range(cfg.model.occ_refresh_phases)] if use_occ
                  else [None])
        for counters in (False, True):
            for phase in phases:
                self._graph(phase, counters)
        self.family = family

    def _graph(self, phase, counters: bool) -> _Graph:
        """The family's graph of ``phase``, with or without the counters'
        device work, captured the first time it is asked for."""
        key = (phase, counters)
        if key not in self.graphs:
            before = [fn.launches for fn in _COUNTED]
            with trace.capturing(counters) as pairs:
                graph = self._capture(lambda: self._work(phase))
            launches = tuple(fn.launches - n
                             for fn, n in zip(_COUNTED, before))
            for fn, n in zip(_COUNTED, before):
                fn.launches = n
            self.graphs[key] = _Graph(graph, pairs, launches)
        return self.graphs[key]

    def _work(self, phase):
        """The device work of one graph, on the family's buffers."""
        params, poses, intrinsics, consts, warmup = self._bound
        b = self.buf
        grid, m = self.device_work(
            params, b.grid, poses, intrinsics,
            StepPlan(phase, warmup, b.var_w, b.level_w), b.cam_idx, b.ij,
            b.gt, b.noise._replace(refresh=None if phase is None
                                   else b.refresh),
            consts, self._zero_grads)
        if phase is not None:
            b.grid.copy_(grid)
        b.metrics.copy_(torch.stack(m))

    def _zero_grads(self) -> None:
        for p in self.optimizer.named.values():
            p.grad.zero_()

    def _capture(self, work):
        """``work`` captured (not run) as a graph in the family's pool."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            work()
        return graph
