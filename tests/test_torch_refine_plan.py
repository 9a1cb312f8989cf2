"""The refinement's route choice and the static candidate stack's host plan,
on the CPU (no JAX, no card).

- Route: CPU tensors, bfloat16 and float64, exact_warp and no disparity
  ceiling keep the plain route, which never reaches the kernels' wrapper, and
  the static-stack pass on the CPU still gives the frozen plain reference's
  bits (``benchmark/reference/array.py::refine``) in float32, bfloat16 and
  float64. On a stand-in card (``resolve_backend`` answering "cuda", the
  wrapper replaced): "auto" takes the kernels for float32 alone, a pass the
  kernels refuse warns and runs the plain route under "auto" and raises
  under "cuda", "torch" and "xla" never reach the kernels, and
  ``array_depth_pipeline`` hands its backend to the refinement.
- Plan: each view's stack bounds, padding and candidate spacing for CROSS,
  to_center (with a zero baseline) and a fractional step, against the
  formulas the plain route has always used; the kernels' table (offsets,
  bounds, float32 baselines, shifts, exact flags and float32 weights) read
  back, and a float32 walk of the kernels' stack sampling from that table
  equal to the plain route's stacks bit for bit.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import array as frozen
from stereovisionarray_tpu_torch.ops import refine, refine_cuda

CROSS = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
_OFF = np.array([(c - 2, r - 2) for r in range(5) for c in range(5) if (r, c) != (2, 2)],
                np.float64)
TO_CENTER_ZERO = np.vstack([(-_OFF / np.linalg.norm(_OFF, axis=1).mean())[:23], [[0.0, 0.0]]])
H, W = 23, 31


def _inputs(bl, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    ref = np.round(rng.uniform(0, 255, (H, W)))
    aux = np.round(rng.uniform(0, 255, (len(bl), H, W)))
    disp = 4.0 + rng.normal(0, 1.0, (H, W))
    disp[:3, :4] = -1.0
    mask = rng.uniform(size=(H, W)) > 0.1
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return t(ref), t(aux), t(disp), torch.from_numpy(mask)


@pytest.fixture
def no_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain route reached the kernels' wrapper")

    monkeypatch.setattr(refine_cuda, "refine_pass", refuse)
    return refuse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("rig,step", [("cross", 1.0), ("cross", 0.5), ("to_center", 1.0)])
def test_plain_static_stack_pass_is_the_frozen_reference(no_kernels, dtype, rig, step):
    bl = CROSS if rig == "cross" else TO_CENTER_ZERO
    ref, aux, disp, mask = _inputs(bl, dtype)
    kw = dict(radius=3, step=step, window=7, subpixel=True)
    got = refine.multiview_refine(ref, aux, bl, disp, mask=mask, max_disparity=20.0, **kw)
    want = frozen.refine(ref, aux, bl, disp, mask, max_disparity=20.0, **kw)
    assert got.disparity.dtype == dtype
    assert torch.equal(got.disparity, want)
    assert bool((got.delta != 0).any())


@pytest.mark.parametrize("exact_warp,max_disparity", [(True, 20.0), (False, None),
                                                      (False, 0.0)])
def test_other_warp_paths_keep_the_plain_route(no_kernels, exact_warp, max_disparity):
    ref, aux, disp, mask = _inputs(CROSS)
    out = refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, radius=2, window=5,
                                  exact_warp=exact_warp, max_disparity=max_disparity)
    assert out.disparity.shape == (H, W) and out.valid.dtype == torch.bool


def test_fusable_only_on_the_card(no_kernels, monkeypatch):
    """Tensors off the card take the plain route under "auto" without
    asking the kernels whether they take the pass."""
    monkeypatch.setattr(refine_cuda, "refusal", no_kernels)
    ref, aux, disp, mask = _inputs(CROSS)
    out = refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, radius=2, window=5,
                                  max_disparity=20.0)
    assert out.disparity.shape == (H, W)


@pytest.mark.parametrize("backend", ["torch", "xla"])
def test_plain_backends_are_the_auto_route_on_the_cpu(no_kernels, backend):
    ref, aux, disp, mask = _inputs(CROSS)
    kw = dict(mask=mask, radius=2, window=5, max_disparity=20.0)
    want = refine.multiview_refine(ref, aux, CROSS, disp, **kw)
    got = refine.multiview_refine(ref, aux, CROSS, disp, backend=backend, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_backend_cuda_refuses_a_cpu_tensor(no_kernels):
    ref, aux, disp, mask = _inputs(CROSS)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, max_disparity=20.0,
                                backend="cuda")


@pytest.fixture
def card(monkeypatch):
    """A stand-in card: "auto" and "cuda" resolve to the kernels; the
    wrapper records its calls and answers with the plain route's outputs,
    and refuses a pass when told to."""
    log = {"refusal": None, "asked": 0, "passes": 0}

    def resolve(tensor, backend="auto"):
        return "cuda" if backend in ("auto", "cuda") else backend

    def refusal(views, h, w, window, device):
        log["asked"] += 1
        return log["refusal"]

    def refine_pass(ref, aux, bl, disp, mask, radius, step, window, subpixel, ceiling):
        log["passes"] += 1
        return refine.multiview_refine(ref, aux, bl, disp, mask=mask, radius=radius, step=step,
                                       window=window, subpixel=subpixel,
                                       max_disparity=ceiling, backend="torch")

    monkeypatch.setattr(refine, "resolve_backend", resolve)
    monkeypatch.setattr(refine_cuda, "refusal", refusal)
    monkeypatch.setattr(refine_cuda, "refine_pass", refine_pass)
    return log


def test_card_runs_a_float32_pass_on_the_kernels(card):
    ref, aux, disp, mask = _inputs(CROSS)
    out = refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, radius=2, window=5,
                                  max_disparity=20.0)
    assert (card["asked"], card["passes"]) == (1, 1)
    assert out.disparity.shape == (H, W)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_card_keeps_other_dtypes_on_the_plain_route(card, dtype):
    ref, aux, disp, mask = _inputs(CROSS, dtype)
    refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, radius=2, window=5,
                            max_disparity=20.0)
    assert (card["asked"], card["passes"]) == (0, 0)


@pytest.mark.parametrize("backend", ["torch", "xla"])
def test_plain_backends_never_ask_the_kernels_on_the_card(card, backend):
    ref, aux, disp, mask = _inputs(CROSS)
    refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, radius=2, window=5,
                            max_disparity=20.0, backend=backend)
    assert (card["asked"], card["passes"]) == (0, 0)


def test_refused_pass_warns_and_runs_plain_under_auto(card):
    card["refusal"] = "too many views"
    ref, aux, disp, mask = _inputs(CROSS)
    kw = dict(mask=mask, radius=2, window=5, max_disparity=20.0)
    with pytest.warns(RuntimeWarning, match="too many views"):
        got = refine.multiview_refine(ref, aux, CROSS, disp, **kw)
    want = refine.multiview_refine(ref, aux, CROSS, disp, backend="torch", **kw)
    assert (card["asked"], card["passes"]) == (1, 0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_refused_pass_raises_under_cuda(card):
    card["refusal"] = "too many views"
    ref, aux, disp, mask = _inputs(CROSS)
    with pytest.raises(ValueError, match="too many views"):
        refine.multiview_refine(ref, aux, CROSS, disp, mask=mask, max_disparity=20.0,
                                backend="cuda")
    assert card["passes"] == 0


@pytest.mark.parametrize("backend", ["auto", "torch", "xla"])
def test_array_pipeline_hands_its_backend_to_the_refinement(monkeypatch, backend):
    from stereovisionarray_tpu_torch.config import EngineConfig
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.models import array_pipeline

    seen = []
    real = array_pipeline.multiview_refine

    def spy(*a, **k):
        seen.append(k["backend"])
        return real(*a, **k)

    monkeypatch.setattr(array_pipeline, "multiview_refine", spy)
    cams = reference_rig(rows=3, cols=3, resolution=(16, 20))
    images = torch.from_numpy(render_camera_array(cams, (16, 20))[0])
    cfg = EngineConfig().override(**{"camera.rows": 3, "camera.cols": 3,
                                     "plane_sweep.num_planes": 8, "refine.radius": 1,
                                     "refine.window": 5})
    array_pipeline.array_depth_pipeline(images, cams, cfg, backend=backend)
    assert seen == [backend]


def _expected_view(bu, bv, radius, step, ceiling):
    """The plain route's bounds and padding of one view, as it always
    computed them (and as the frozen reference still does)."""
    off_hi = abs(radius * step)
    blen = float(np.hypot(bu, bv))
    if blen < 1e-12:
        return 0, 0, 2
    ux, uy = bu / blen, bv / blen
    s_lo = int(np.floor(-off_hi * blen))
    s_hi = int(np.ceil((ceiling + off_hi) * blen))
    return s_lo, s_hi, int(np.ceil(max(abs(s_lo), abs(s_hi)) * max(abs(ux), abs(uy)))) + 2


@pytest.mark.parametrize("rig,step,q", [
    ("cross", 1.0, (1, 1, 1, 1)),
    ("cross", 2.0, (2, 2, 2, 2)),
    ("cross", 0.5, None),  # fractional candidate spacing: the hat blend
    ("to_center", 1.0, None),
])
def test_plan_bounds_padding_and_spacing(rig, step, q):
    bl = CROSS if rig == "cross" else TO_CENTER_ZERO
    plan = refine.stack_plan(bl, 5, step, 51.0)
    assert plan.q == q
    assert len(plan.views) == len(bl)
    for (bu, bv), p in zip(bl, plan.views):
        assert (p.s_lo, p.s_hi, p.pad) == _expected_view(bu, bv, 5, step, 51.0)
        assert len(p.shifts) == p.s_hi - p.s_lo + 1
        blen = float(np.hypot(bu, bv))
        if blen:
            ux, uy = bu / blen, bv / blen
            for s, (j0, i0, fv, fu) in zip(range(p.s_lo, p.s_hi + 1), p.shifts):
                assert (j0, i0) == (int(np.floor(s * uy)), int(np.floor(s * ux)))
                assert (fv, fu) == (s * uy - j0, s * ux - i0)
    if rig == "to_center":
        assert plan.views[-1].shifts == ((0, 0, 0.0, 0.0),)
    assert refine.stack_plan(bl, 5, step, 51.0) is plan  # cached


def _table_stack(table, num, v, aux):
    """A float32 walk of csrc/refine.cu's stack_entry over every step of
    view v, from the kernels' table: the (S, H, W) stack the kernels sample."""
    f = table.view(np.float32)
    s_lo, s_hi, first = (int(x) for x in table[num + 8 * v: num + 8 * v + 3])
    h, w = aux.shape
    out = []
    for k in range(s_hi - s_lo + 1):
        i0, j0, exact = (int(x) for x in table[first + 8 * k: first + 8 * k + 3])
        wu0, wu1, wv0, wv1 = f[first + 8 * k + 4: first + 8 * k + 8]
        yy, xx = np.arange(h)[:, None] + j0, np.arange(w)[None, :] + i0

        def px(dy, dx):
            y, x = yy + dy, xx + dx
            inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            return np.where(inside, aux[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)],
                            np.float32(0)).astype(np.float32)

        if exact:
            out.append(px(0, 0))
            continue
        top = px(0, 0) * wu0 + px(0, 1) * wu1
        bot = px(1, 0) * wu0 + px(1, 1) * wu1
        out.append(top * wv0 + bot * wv1)
    return np.stack(out)


@pytest.mark.parametrize("rig,step", [("cross", 1.0), ("cross", 0.5), ("to_center", 1.0)])
def test_kernel_table_is_the_plain_routes_plan(rig, step):
    bl = CROSS if rig == "cross" else TO_CENTER_ZERO
    radius, num = 3, 7
    plan = refine.stack_plan(bl, radius, step, 20.0)
    table = plan.table
    f = table.view(np.float32)
    offsets = (np.arange(num, dtype=np.float64) - radius) * step
    assert np.array_equal(f[:num], offsets.astype(np.float32))
    _, aux, _, _ = _inputs(bl)
    stacks = refine._build_stacks(aux, plan)
    for v, (p, stack) in enumerate(zip(plan.views, stacks)):
        head = table[num + 8 * v: num + 8 * v + 8]
        assert tuple(head[:2]) == (p.s_lo, p.s_hi) and head[2] % 8 == 0
        assert head[3] == (plan.q[v] if plan.q is not None else 0)
        assert np.array_equal(head[4:7].view(np.float32),
                              np.array([p.bu, p.bv, p.blen], np.float32))
        walked = _table_stack(table, num, v, aux[v].numpy())
        assert walked.dtype == np.float32
        assert np.array_equal(walked.view(np.int32), stack.numpy().view(np.int32))
