"""The frame's resize on the card (``f2nerf_tpu_torch/kernels/resize.py``,
``csrc/resize_aa.cu``) against its specification,
``utils/image_io.resize_image``.

On the CPU: the taps and weights read from ATen, the split of each sum
into rounded and fused taps (the width and height passes' float32 sums
equal ATen's, bit for bit), and the plain version of the kernel against
``resize_image`` on random frames, on frames at the quantization
boundaries and outside [0, 1]; the service's choice of path. On the
card (marked ``cuda``, skipped without one): the kernel against
``resize_image`` on node-sized frames, and the service on a CUDA
localizer.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from f2nerf_tpu_torch.apps import serve as tserve
from f2nerf_tpu_torch.kernels import resize
from f2nerf_tpu_torch.localize.localizer import Particle
from f2nerf_tpu_torch.utils import trace
from f2nerf_tpu_torch.utils.image_io import resize_image

# the shapes of test_torch_localize.py::test_resize_image_vs_pil
SHAPES = [((48, 64), (24, 32)), ((50, 70), (24, 32)),
          ((850, 1920), (106, 240))]
NODE = ((850, 1920), (106, 240))     # the node's row crop -> the render size


def _smooth_frame(rng, hw) -> np.ndarray:
    """test_resize_image_vs_pil's frame: a coarse random image enlarged
    bilinearly, with noise, in [0, 1]."""
    base = rng.random((hw[0] // 10 + 2, hw[1] // 10 + 2, 3))
    img = F.interpolate(torch.from_numpy(base).permute(2, 0, 1)[None],
                        size=hw, mode="bilinear", align_corners=False)
    img = img[0].permute(1, 2, 0).numpy()
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(
        np.float32)


def _boundary_frame(rng, hw) -> np.ndarray:
    """Values on the quantize's boundaries, (k - 0.5) / 255 in float32 for
    k = 0 .. 256 and their float32 neighbours, and values below 0 and
    above 1."""
    k = np.arange(257, dtype=np.float64)
    edge = ((k - 0.5) / 255).astype(np.float32)
    vals = np.concatenate([edge, np.nextafter(edge, np.float32(-1)),
                           np.nextafter(edge, np.float32(2)),
                           np.float32([-1e3, -1.0, -1e-3, 1.001, 2.0, 1e3])])
    return rng.choice(vals, (*hw, 3)).astype(np.float32)


def _target_frame(rng, dst, src) -> np.ndarray:
    """``portbench/inputs.target_frames``'s shape of frame: an image at
    the render size enlarged by whole pixels, edge rows repeated to the
    node's size."""
    factor = src[1] // dst[1]
    small = _smooth_frame(rng, dst)
    big = np.repeat(np.repeat(small, factor, 0), factor, 1)
    big = np.pad(big, ((0, max(src[0] - big.shape[0], 0)),
                       (0, max(src[1] - big.shape[1], 0)), (0, 0)),
                 mode="edge")[:src[0], :src[1]]
    return np.ascontiguousarray(big, dtype=np.float32)


@pytest.mark.parametrize("n_in,n_out", [(850, 106), (1920, 240), (50, 24),
                                        (70, 32), (48, 24)])
def test_axis_taps(n_in, n_out):
    """Each output's weights sum to 1 within float32 rounding, and its
    taps are ATen's support (``_compute_index_ranges_weights``, in
    float32): centre scale * (i + 0.5), half-width max(scale, 1)."""
    first, count, weight = resize._axis(n_in, n_out)
    assert weight.dtype == torch.float32 and (weight >= 0).all()
    sums = weight.double().sum(1)
    assert (sums - 1).abs().max() <= count.max() * 2.0 ** -23
    scale = np.float32(n_in) / np.float32(n_out)
    support = max(scale, np.float32(1))
    centre = scale * (np.arange(n_out, dtype=np.float32) + np.float32(0.5))
    lo = np.maximum((centre - support + np.float32(0.5)).astype(np.int64), 0)
    hi = np.minimum((centre + support + np.float32(0.5)).astype(np.int64),
                    n_in)
    np.testing.assert_array_equal(first.numpy(), lo)
    np.testing.assert_array_equal(count.numpy(), hi - lo)
    # the weights are the filter's: a tap's weight is what the identity
    # gives that input, and zero outside its taps
    eye = F.interpolate(torch.eye(n_in)[None, None], size=(n_in, n_out),
                        mode="bilinear", align_corners=False,
                        antialias=True)[0, 0]
    for i in (0, n_out // 2, n_out - 1):
        np.testing.assert_array_equal(
            weight[i, :count[i]].numpy(),
            eye[first[i]:first[i] + count[i], i].numpy())
        assert eye[:first[i], i].eq(0).all()
        assert eye[first[i] + count[i]:, i].eq(0).all()


@pytest.mark.parametrize("src,dst", SHAPES)
def test_sums_equal_aten(src, dst):
    """The chosen split gives ATen's float32 sums bit for bit, in the
    width pass (on a quantized frame) and in the height pass (on its
    float32 result), each at a seed other than the split's own."""
    (h_in, w_in), (h, w) = src, dst
    rows, cols = resize.frame_taps(h_in, w_in, 3, h, w)
    g = torch.Generator().manual_seed(11)
    q = torch.randint(0, 256, (h_in, w_in, 3), dtype=torch.uint8,
                      generator=g)
    mid = resize._aten(q, h_in, w)
    got = resize._sum_taps(q.float().transpose(0, 1), *cols).transpose(0, 1)
    assert torch.equal(got, mid)
    got = resize._sum_taps(mid, *rows)
    assert torch.equal(got, resize._aten(mid, h, w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("src,dst", SHAPES)
def test_plain_version_equals_resize_image(src, dst, seed):
    """The kernel's arithmetic on the CPU gives resize_image's float32
    values bit for bit, through the wrapper's CPU path."""
    rng = np.random.default_rng(seed)
    img = _smooth_frame(rng, src)
    out = resize.resize_aa(torch.from_numpy(img), *dst)
    assert out.dtype == torch.float32 and out.shape == (*dst, 3)
    np.testing.assert_array_equal(out.numpy(), resize_image(img, *dst))


@pytest.mark.parametrize("src,dst", SHAPES)
def test_plain_version_on_quantize_boundaries(src, dst):
    rng = np.random.default_rng(7)
    img = _boundary_frame(rng, src)
    np.testing.assert_array_equal(
        resize.resize_aa_ref(torch.from_numpy(img), *dst).numpy(),
        resize_image(img, *dst))


def test_plain_version_on_a_target_frame():
    rng = np.random.default_rng(3)
    img = _target_frame(rng, NODE[1], NODE[0])
    np.testing.assert_array_equal(
        resize.resize_aa_ref(torch.from_numpy(img), *NODE[1]).numpy(),
        resize_image(img, *NODE[1]))


def test_wrapper_checks_its_frame():
    with pytest.raises(ValueError, match="float32"):
        resize.resize_aa(torch.zeros((8, 8, 3), dtype=torch.float64), 4, 4)
    with pytest.raises(ValueError, match="float32"):
        resize.resize_aa(torch.zeros((8, 8)), 4, 4)


class _Localizer:
    """What ``LocalizerService`` asks of a localizer in mode 0, keeping
    the image each frame hands it."""

    def __init__(self, device, hw):
        self.device = torch.device(device)
        self.infer_height, self.infer_width = hw
        self.images = []

    def world2camera(self, pose):
        return np.asarray(pose, np.float32)[:3, :4]

    def camera2world(self, pose):
        return np.concatenate([pose, np.float32([[0, 0, 0, 1]])])

    def optimize_pose_by_random_search(self, pose, image, n, noise_coeff):
        self.images.append(image)
        return [Particle(pose=pose, weight=1.0)]

    def render_image(self, pose):
        return torch.full((self.infer_height, self.infer_width, 3), 0.5,
                          device=self.device)


def _serve_frames(loc, frames) -> dict:
    """Each frame through ``handle`` under a profiler; the counters."""
    svc = tserve.LocalizerService(loc)
    assert svc.handle({"cmd": "init_pose",
                       "pose": np.eye(4).tolist()})["ok"]
    trace.reset()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        for f in frames:
            assert svc.handle({"cmd": "localize", "image": f, "mode": 0,
                               "particle_num": 1})["ok"]
        counts = trace.counts()
    trace.reset()
    return counts


def test_service_resizes_on_the_host_for_a_cpu_localizer(monkeypatch):
    """A CPU localizer's frame goes through resize_image, unchanged, and
    nothing is counted as resized on the card."""
    calls = []

    def spy(image, h, w):
        calls.append(image.shape)
        return resize_image(image, h, w)

    monkeypatch.setattr(tserve, "resize_image", spy)
    rng = np.random.default_rng(5)
    frames = [_smooth_frame(rng, (50, 70)) for _ in range(2)]
    loc = _Localizer("cpu", (24, 32))
    counts = _serve_frames(loc, frames + [frames[0].tolist()])
    assert calls == [(50, 70, 3)] * 3
    assert counts.get("serve.resize_card", 0) == 0
    for f, got in zip(frames, loc.images):
        np.testing.assert_array_equal(got, resize_image(f, 24, 32))
    # a frame already at the render size is not resized
    _serve_frames(loc, [resize_image(frames[0], 24, 32)])
    assert len(calls) == 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on_card(img: np.ndarray, dst) -> np.ndarray:
    out = resize.resize_aa(torch.from_numpy(img).cuda(), *dst)
    torch.cuda.synchronize()
    return out.cpu().numpy()


@pytest.mark.cuda
def test_kernel_equals_resize_image(cuda):
    """16 random node frames, boundary frames and target frames, bit for
    bit; and the other shapes of test_resize_image_vs_pil."""
    rng = np.random.default_rng(21)
    src, dst = NODE
    before = resize.resize_aa.launches
    frames = [_smooth_frame(rng, src) for _ in range(8)]
    frames += [rng.random((*src, 3), dtype=np.float32) for _ in range(8)]
    frames += [_boundary_frame(rng, src) for _ in range(2)]
    frames += [_target_frame(rng, dst, src) for _ in range(4)]
    for i, img in enumerate(frames):
        np.testing.assert_array_equal(_on_card(img, dst),
                                      resize_image(img, *dst), err_msg=i)
    assert resize.resize_aa.launches == before + len(frames)
    for s, d in SHAPES[:2]:
        for img in (_smooth_frame(rng, s), _boundary_frame(rng, s)):
            np.testing.assert_array_equal(_on_card(img, d),
                                          resize_image(img, *d))


@pytest.mark.cuda
def test_kernel_takes_a_strided_frame(cuda):
    """A frame that is a view (the node's row crop of a wider array) is
    made contiguous first."""
    rng = np.random.default_rng(4)
    whole = _smooth_frame(rng, (60, 90))
    crop = whole[5:55, 10:80]
    out = resize.resize_aa(torch.from_numpy(whole).cuda()[5:55, 10:80],
                           24, 32)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  resize_image(crop, 24, 32))


@pytest.mark.cuda
def test_service_resizes_on_the_card(cuda):
    """A CUDA localizer's frames are resized by the kernel, counted once
    each, and the localizer gets resize_image's image."""
    rng = np.random.default_rng(8)
    src, dst = NODE
    frames = [_smooth_frame(rng, src) for _ in range(3)]
    frames.append(frames[0][::1, :, :].copy(order="F"))   # not C-contiguous
    loc = _Localizer(cuda, dst)
    before = resize.resize_aa.launches
    counts = _serve_frames(loc, frames)
    assert counts["serve.resize_card"] == len(frames)
    assert resize.resize_aa.launches == before + len(frames)
    for f, got in zip(frames, loc.images):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, resize_image(f, *dst))
