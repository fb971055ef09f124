"""The comparison that decides ``correct``: each number the plain
reference gives for what the timed path produced, beside its limit from
``portbench/limits/<workload>.json``.

The numbers are gaps, each 0 for an exact match, in the units that its
function documents. A run is correct when every number is finite and at
most its limit. The same functions read the control (the reference in
a lower precision, put in the program's place; ``portbench/control.py``).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from portbench.reference import localize as RL

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
ROUNDOFF_LEAF = 1e-3


def within(numbers: dict, limits: dict) -> bool:
    """Every limited number read, finite and at most its limit; a number
    without a limit is not compared."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())


def report(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the order of ``limits``."""
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits if k in numbers}


# -- frames ------------------------------------------------------------------

def simulate_frame(mp: RL.Map, state: dict, image: np.ndarray, mode: int,
                   particle_num: int) -> dict:
    """A frame's outputs as the program gives them (reply pose in world
    coordinates, rendered reply image, score; mode 0 the particle
    weights, mode 1 the loss and the pose gradient), computed by the
    reference map ``mp``: the control puts this in the program's place."""
    out = {}
    if mode == 0:
        res = RL.mode0(mp, state["rng"], state["prior"], state["prev_score"],
                       image, particle_num)
        out["weights"], pose = res["weights"], res["pose"]
    else:
        out["loss"], out["grad"] = RL.pose_loss_grad(mp, state["prior"], image)
        pose = RL.adam_first_step(state["prior"], out["grad"])
    out["pose_world"] = RL.camera2world(pose)
    out["rendered"] = mp.image(pose)
    out["score"] = RL.score(out["rendered"], image)
    return out


def frame_numbers(got: dict, mp: RL.Map, state: dict, image: np.ndarray,
                  mode: int, particle_num: int) -> dict:
    """The gaps of one frame's outputs ``got`` (see :func:`simulate_frame`)
    from the reference's, which follows the frame from ``state``:

    * ``weight_gap``: largest particle-weight gap over the largest
      reference weight (mode 0);
    * ``pose_gap``: largest entry gap of the reply's world pose (mode 0);
    * ``loss_gap``: relative gap of the differential loss (mode 1);
    * ``grad_gap``: largest entry gap of the pose gradient over its norm
      (mode 1);
    * ``step_gap``: largest gap of the reply's translation from one Adam
      step on the program's own gradient, in units of the step's lr
      (mode 1);
    * ``image_gap``: largest pixel gap of the rendered reply from the
      reference's render at the reply's pose;
    * ``score_gap``: relative gap of the reply's score.
    """
    nums = {}
    pose = RL.world2camera(got["pose_world"])
    # a reading the program never produced compares as NaN: not correct
    nan = float("nan")
    if mode == 0:
        ref = RL.mode0(mp, state["rng"], state["prior"], state["prev_score"],
                       image, particle_num)
        w = np.asarray(got.get("weights", nan), np.float64)
        nums["weight_gap"] = float(np.max(np.abs(w - ref["weights"]))
                                   / np.max(ref["weights"]))
        nums["pose_gap"] = float(np.max(np.abs(
            np.asarray(got["pose_world"], np.float64)
            - RL.camera2world(ref["pose"]))))
    else:
        loss, grad = RL.pose_loss_grad(mp, state["prior"], image)
        got_grad = np.asarray(got.get("grad", np.full((3, 4), nan)))
        nums["loss_gap"] = abs(got.get("loss", nan) - loss) / abs(loss)
        nums["grad_gap"] = float(np.max(np.abs(got_grad - grad))
                                 / np.linalg.norm(grad))
        want = RL.adam_first_step(state["prior"], got_grad)
        nums["step_gap"] = float(np.max(np.abs(
            pose[:, 3].astype(np.float64) - want[:, 3])) / RL.DIFF_LR)
    ref_img = mp.image(pose)
    nums["image_gap"] = float(np.max(np.abs(
        np.asarray(got["rendered"], np.float32) - ref_img)))
    ref_score = RL.score(ref_img, image)
    nums["score_gap"] = abs(got["score"] - ref_score) / abs(ref_score)
    return nums


def worst(per_frame: list[dict]) -> dict:
    """Each number's largest value over the frames."""
    return {k: max(d[k] for d in per_frame) for k in per_frame[0]}


# -- training ----------------------------------------------------------------

def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def train_numbers(got: dict, ref: dict, p0: dict) -> dict:
    """The gaps of the first steps' readings ``got`` from the reference's
    ``ref`` (``reference.train.steps``), both from the params ``p0``:

    * ``loss_gap``: largest relative gap of a step's loss;
    * ``grad_gap``: worst leaf's gap between the norms of the first
      gradient as Adam takes it, over the larger of the reference
      leaf's norm and the median leaf's;
    * ``change_gap``: the same for the params' change over the steps,
      leaving out leaves whose reference gradient is under
      :data:`ROUNDOFF_LEAF` of the median leaf's;
    * ``grid_gap``: largest relative gap of the occupancy grid after the
      first step (a refresh step), where the configuration samples by it.

    ``got``: {"loss": [floats], "grad": {leaf: tensor}, "params": {leaf:
    tensor} after the steps, "grid": the grid after the first step or
    None}.
    """
    nums = {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got["loss"], ref["loss"]))}
    g_got, g_ref = _norms(got["grad"]), _norms(ref["grad"])
    med = float(np.median(list(g_ref.values())))
    nums["grad_gap"] = max(abs(g_got[k] - g_ref[k]) / max(g_ref[k], med)
                           for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= ROUNDOFF_LEAF * med]
    if len(moved) < len(g_ref):
        print(f"change_gap leaves out, as moved by round-off alone: "
              f"{sorted(set(g_ref) - set(moved))}", file=sys.stderr)
    c_got = _norms({k: got["params"][k].cpu() - p0[k].cpu() for k in moved})
    c_ref = _norms({k: ref["params"][k].cpu() - p0[k].cpu() for k in moved})
    med_c = float(np.median(list(c_ref.values())))
    nums["change_gap"] = max(abs(c_got[k] - c_ref[k]) / max(c_ref[k], med_c)
                             for k in moved)
    if got.get("grid") is not None:
        a = got["grid"].double().cpu()
        b = ref["grid"][0].double().cpu()
        nums["grid_gap"] = float(torch.max(
            torch.abs(a - b) / torch.clamp_min(torch.abs(b), 1e-9)))
    return nums
