"""The refinement's fused CUDA route (``ops/refine_cuda.py``,
``csrc/refine.cu``) against the plain static-stack route on the same CUDA
tensors, all four outputs bit for bit: the CROSS rig's integer candidate
spacing and the hat blend (to_center rigs, fractional steps), radius 1 to 5,
windows from 1 to wider than the image (and an even one), one view to 24
with a zero baseline among them, shapes whose row scans PyTorch chunks by
32, 64 and 1,024 elements (270x360, 375x1242, 8x4096, and 2048x2, where
ATen's uint32 difference wraps), the widest row the kernels take and 63
views, with and without a mask, disparities at or below 0 and past the
ceiling, and two passes in a row; the passes the kernels refuse (one column
more, 64 views, a window on a single row), which raise under "cuda" and warn
and run the plain route under "auto"; and at the benchmark's configuration,
the array pipeline's refined depth equal to the frozen reference of
``benchmark/reference/array.py``, its "torch" backend running the plain
route.

Needs a CUDA device and nvcc; without one every test skips:

    python -m pytest --noconftest -m gpu tests/test_torch_refine_cuda.py -q
"""

import numpy as np
import pytest
import torch

from stereovisionarray_tpu_torch.ops import refine, refine_cuda
from torch_launches import launched  # noqa: F401

pytestmark = pytest.mark.gpu

CROSS = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])


def _to_center(zero=False):
    off = np.array([(c - 2, r - 2) for r in range(5) for c in range(5) if (r, c) != (2, 2)],
                   np.float64)
    bl = -off / np.linalg.norm(off, axis=1).mean()
    return np.vstack([bl[:23], [[0.0, 0.0]]]) if zero else bl


RIGS = {
    "cross": CROSS,
    "cross_zero": np.vstack([CROSS, [[0.0, 0.0]]]),
    "to_center": _to_center(),
    "to_center_zero": _to_center(zero=True),
    "one_axis": np.array([[1.0, 0.0]]),
    "one_vertical": np.array([[0.0, -1.0]]),
    "one_diagonal": np.array([[0.6, -0.8]]),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs(bl, h, w, d_true=6.0, seed=0):
    """Integer-valued textures (the 8-bit frames' values), each view the
    reference shifted by its baseline at d_true plus noise, and a disparity
    around d_true with a patch at or below 0, one past the ceiling and one of
    whole pixels."""
    rng = np.random.default_rng(seed)
    pad = 40
    big = rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad))
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1) + np.roll(big, (1, 1), (0, 1))) / 4
    ref = np.round(big[pad:pad + h, pad:pad + w])
    aux = []
    for bu, bv in bl:
        dy, dx = int(round(bv * d_true)), int(round(bu * d_true))
        view = big[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
        aux.append(np.clip(np.round(view + rng.normal(0, 2, (h, w))), 0, 255))
    disp = d_true + rng.normal(0, 0.8, (h, w))
    kh, kw = max(h // 8, 1), w // 8
    disp[:kh, :kw] = rng.uniform(-3, 0, (kh, kw))
    disp[-kh:, :kw] = 60.0 + rng.uniform(0, 20, (kh, kw))
    disp[-kh:, -kw:] = np.round(disp[-kh:, -kw:])
    mask = rng.uniform(size=(h, w)) > 0.1
    cuda = lambda a, t=torch.float32: torch.from_numpy(np.asarray(a)).to(t).cuda()  # noqa: E731
    return (cuda(ref), cuda(np.stack(aux)), cuda(disp), cuda(mask, torch.bool))


def _both(launched, ref, aux, bl, disp, mask, iterations=1, **kw):
    """(fused outputs, plain outputs) after `iterations` passes each: the
    fused route's two entry points a pass, the plain route's none."""
    def run(backend):
        d, out = disp, None
        for _ in range(iterations):
            out = refine.multiview_refine(ref, aux, bl, d, mask=mask, backend=backend, **kw)
            d = out.disparity
        return out

    launched.clear()
    fused = run("cuda")
    assert launched == ["svt_refine_costs", "svt_refine_select"] * iterations, launched
    launched.clear()
    plain = run("torch")
    assert launched == [], "the plain route launched the kernels"
    return fused, plain


def _same(fused, plain):
    for field in refine.RefineOutput._fields:
        a, b = getattr(fused, field), getattr(plain, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if a.dtype == torch.bool:
            n = int((a != b).sum())
        else:
            n = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        assert n == 0, f"{field}: {n} elements differ"


@pytest.mark.parametrize("rig,h,w,step,radius,window,masked", [
    ("cross", 40, 56, 1.0, 1, 1, False),
    ("cross", 40, 56, 1.0, 3, 3, True),
    ("cross", 40, 56, 1.0, 5, 21, True),
    ("cross", 40, 56, 1.0, 3, 4, True),  # an even window: k + 1 wide, as box_filter2d sums
    ("cross", 40, 56, 1.0, 3, 121, False),  # wider than the image
    ("cross", 40, 56, 0.5, 3, 11, True),  # fractional spacing: the hat blend
    ("cross_zero", 40, 56, 1.0, 3, 11, True),
    ("to_center", 40, 56, 1.0, 3, 11, True),
    ("to_center_zero", 40, 56, 0.5, 5, 21, False),
    ("one_axis", 40, 56, 1.0, 5, 21, True),
    ("one_diagonal", 40, 56, 1.0, 3, 3, False),
    ("cross", 270, 360, 1.0, 5, 21, True),  # the benchmark's pass
    ("cross", 270, 360, 0.5, 5, 21, False),
    ("to_center_zero", 270, 360, 1.0, 5, 21, True),
    ("one_axis", 270, 360, 1.0, 1, 1, True),
    ("cross", 375, 1242, 1.0, 5, 21, True),  # PyTorch scans rows in chunks of 64 here
    ("cross_zero", 375, 1242, 1.0, 3, 11, False),
    ("one_diagonal", 375, 1242, 0.5, 1, 3, True),
    ("cross", 8, 4096, 1.0, 3, 11, True),  # chunks of 1,024
    ("one_vertical", 2048, 2, 1.0, 1, 3, True),  # the uint32 difference wraps: chunks of 1,024
    ("cross", 1000, 8, 1.0, 1, 5, False),
    ("one_axis", 1, 56, 1.0, 3, 1, True),  # a single row without a window
])
def test_fused_pass_is_the_plain_route(card, launched, rig, h, w, step, radius, window, masked):
    bl = RIGS[rig]
    ref, aux, disp, mask = _inputs(bl, h, w, seed=h + radius)
    fused, plain = _both(launched, ref, aux, bl, disp, mask if masked else None,
                         radius=radius, step=step, window=window, max_disparity=48.0)
    _same(fused, plain)
    assert bool(plain.valid.any()) and bool((plain.delta != 0).any())


@pytest.mark.parametrize("rig,subpixel", [("cross", True), ("to_center", False)])
def test_two_passes_are_the_plain_route(card, launched, rig, subpixel):
    bl = RIGS[rig]
    ref, aux, disp, mask = _inputs(bl, 61, 83, seed=5)
    fused, plain = _both(launched, ref, aux, bl, disp, mask, iterations=2, radius=3,
                         step=1.0, window=11, subpixel=subpixel, max_disparity=48.0)
    _same(fused, plain)


def _device():
    return torch.device("cuda", torch.cuda.current_device())


def _widest_row():
    """The widest row of one view the kernels take with a window (its scan
    in a block's shared memory, opted in above 48 KB)."""
    lo, hi = 1024, 1 << 16  # taken, refused
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if refine_cuda.refusal(1, 2, mid, 3, _device()) is None else (lo, mid)
    return lo


def _views(n, h, w):
    """n baselines around the reference, none of them zero."""
    a = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    return np.stack([np.cos(a), np.sin(a)], 1) * (1.0 + (np.arange(n) % 3) / 2)[:, None]


def test_widest_row_and_most_views_are_fused(card, launched):
    w = _widest_row()
    assert 20000 < w < 40000
    bl = RIGS["one_diagonal"]
    ref, aux, disp, mask = _inputs(bl, 2, w)
    _same(*_both(launched, ref, aux, bl, disp, mask, radius=1, step=1.0, window=3,
                 max_disparity=12.0))
    bl = _views(63, 40, 56)
    ref, aux, disp, mask = _inputs(bl, 40, 56)
    _same(*_both(launched, ref, aux, bl, disp, mask, radius=2, step=1.0, window=5,
                 max_disparity=24.0))


@pytest.mark.parametrize("case", ["one_column_more", "64_views", "one_row_window"])
def test_refused_pass_raises_under_cuda_and_runs_plain_under_auto(card, launched, case):
    h, w, bl = {"one_column_more": (2, _widest_row() + 1, RIGS["one_diagonal"]),
                "64_views": (40, 56, _views(64, 40, 56)),
                "one_row_window": (1, 56, RIGS["one_axis"])}[case]
    ref, aux, disp, mask = _inputs(bl, h, w)
    kw = dict(mask=mask, radius=1, step=1.0, window=3, max_disparity=12.0)
    assert refine_cuda.refusal(len(bl), h, w, 3, _device()) is not None
    with pytest.raises(ValueError, match="refuse this pass"):
        refine.multiview_refine(ref, aux, bl, disp, backend="cuda", **kw)
    launched.clear()
    with pytest.warns(RuntimeWarning, match="plain route"):
        got = refine.multiview_refine(ref, aux, bl, disp, **kw)
    assert launched == []
    _same(got, refine.multiview_refine(ref, aux, bl, disp, backend="torch", **kw))


def test_benchmark_configuration_is_the_frozen_reference(card, launched):
    """array_depth_pipeline on a seeded frame-set of array5x5_cross (270x360,
    128 planes, CROSS, radius 5, window 21): its refined depth, depth and
    validity equal the frozen plain reference on the card, bit for bit."""
    from benchmark import harness, pipelines, scenes
    from benchmark.reference import array as array_ref
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.geometry.camera import camera_array_from_numpy
    from stereovisionarray_tpu_torch.models import array_depth_pipeline

    config = harness.load_json(harness.ROOT / "benchmark/configs/array5x5_cross.json")
    rig = scenes.grid_rig(config["rig"])
    h, w = config["rig"]["resolution"]
    frames = scenes.to_uint8(scenes.render_rig(rig, h, w, seed=12345, device="cuda"))
    cams = camera_array_from_numpy(*(rig[k] for k in ("fx", "fy", "cx", "cy", "R", "t")),
                                   device="cuda")
    cfg = EngineConfig.from_dict(config["engine"])
    launched.clear()
    out = array_depth_pipeline(frames.to(torch.float32), cams, cfg)
    assert [n for n in launched if n.startswith("svt_refine")] == ["svt_refine_costs",
                                                                   "svt_refine_select"]
    want = array_ref.depth(frames, rig, config["engine"])
    got = {"depth": out.depth, "refined_depth": out.refined_depth, "valid": out.valid}
    assert pipelines.mismatches(torch, got, want) == {k: 0 for k in want}
    assert not torch.equal(want["depth"], want["refined_depth"])
    launched.clear()
    plain = array_depth_pipeline(frames.to(torch.float32), cams, cfg, backend="torch")
    assert launched == []
    for field in ("refined_depth", "refined_disparity"):
        assert torch.equal(getattr(plain, field), getattr(out, field)), field
