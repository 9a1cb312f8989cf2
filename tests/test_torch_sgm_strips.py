"""K7's strip route (``svt_sgm_float_strips`` in ``csrc/sgm_paths.cu``), on the CPU.

The route sums the float SGM paths in three launches: the horizontal walks
(left->right and right->left, each row a line) into two buffers; the down
pass, a cooperative kernel that walks the down group (down, down-right,
down-left) strip by strip, S rows at a time, into a ring of two slots and,
in the same phase, sums the strip before into the down group's buffer A;
the up pass, which walks the up group from the bottom strip up and, for the
strip before, sums the up group B and the route's total from A, the two
horizontal buffers and, on the rows the reference fuses, the costs.

Here the plan (``ops/sgm_cuda._strip_plan``) is held to the float paths'
shapes and refusals, the wrapper's route to the entry point it launches, and
a PyTorch emulation of the three launches, built on ``ops/sgm._step_float``
with the kernel's segment enumeration, slot addressing and per-phase
combine, is held bit for bit to the plain twin ``aggregate_paths_float`` (and
once to the JAX reference in interpret mode)."""

import numpy as np
import pytest
import torch

import chip_smoke
from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.ops import sgm_cuda
from stereovisionarray_tpu_torch.ops.sgm import (
    ALL_SWEEPS,
    ORDERS,
    _scan_setup,
    _step_float,
    aggregate_paths_float,
    fma3,
    p2_maps,
)
from stereovisionarray_tpu_torch.ops.sgm_cuda import MAX_STRIP_ROWS, STRIP_RING_BYTES, _strip_plan

# a vertical group's paths as the kernel orders them in the ring: (path id, dy, dx),
# the axis path, then diag+1, then diag-1 (ops/sgm.SWEEP_PATHS_8)
GROUPS = {"down": ((0, 1, 0), (4, 1, 1), (5, 1, -1)), "up": ((1, -1, 0), (6, -1, 1), (7, -1, -1))}


def segments(h, w, S, strip, dy, dx):
    """The kernel's segments of one path in strip `strip` (rows [strip * S,
    min(h, strip * S + S))): each segment i < w starts at the strip's first
    row in its walking direction at column i, carried from the pixel one step
    back (the strip before) where that lies in the image, else fresh; with a
    diagonal, segment w - 1 + j (j >= 1) enters from the side edge j rows in,
    fresh. Returns (y, x, length, pred_y, pred_x, carried) as int64 arrays."""
    y0 = strip * S
    n = min(S, h - y0)
    ys = y0 if dy > 0 else y0 + n - 1
    i = np.arange(w + (n - 1 if dx else 0))
    j = i - w + 1
    entering = i >= w
    y = np.where(entering, ys + dy * j, ys)
    x = np.where(entering, 0 if dx > 0 else w - 1, i)
    cols = w - x if dx > 0 else (x + 1 if dx < 0 else np.full_like(x, n))
    length = np.minimum(np.where(entering, n - j, n), cols)
    py, px = y - dy, x - dx
    carried = ~entering & (py >= 0) & (py < h) & (px >= 0) & (px < w)
    return y, x, length, py, px, carried


def _walk_strip(vol, p2, p1, ring, slot_path, strip, S, dy, dx):
    """One path's walk of one strip: every segment at once, step by step, as
    the kernel's line groups run; each L goes to ring[(y // S) % 2, slot_path,
    y % S, x], a carried segment's first step reads its predecessor there."""
    h, w, _ = vol.shape
    y, x, length, py, px, carried = (torch.from_numpy(a) for a in segments(h, w, S, strip, dy,
                                                                          dx))
    prev = None
    for t in range(int(length.max())):
        act = length > t
        yy, xx = y[act] + dy * t, x[act] + dx * t
        c = vol[yy, xx]
        step_p2 = p2[yy, xx][:, None]
        if t == 0:
            pred = ring[(py // S) % 2, slot_path, py % S, px.clamp(0, w - 1)]
            L = torch.where(carried[:, None], _step_float(pred, c, p1, step_p2), c)
        else:
            L = _step_float(prev[act], c, p1, step_p2)
        ring[(yy // S) % 2, slot_path, yy % S, xx] = L
        full = torch.full((len(length), vol.shape[2]), float("nan"))
        full[act] = L
        prev = full


def _horizontal(vol, p2_x, p1, dx):
    """Launch 1: one row a line, walked left->right (dx = 1) or back."""
    h, w, _ = vol.shape
    out = torch.full_like(vol, float("nan"))
    cols = range(w) if dx > 0 else range(w - 1, -1, -1)
    prev = None
    for x in cols:
        prev = vol[:, x].clone() if prev is None else _step_float(prev, vol[:, x], p1,
                                                                  p2_x[:, x][:, None])
        out[:, x] = prev
    return out


def emulate_strips(vol, p2_y, p2_x, p1, num_paths, order, S):
    """The three launches of the strip route: the (H, W, D) float32 total."""
    h, w, D = vol.shape
    vol, (p2_y, p2_x), p1, _, _ = _scan_setup(vol, p2_y, p2_x, p1)
    horiz = [_horizontal(vol, p2_x, p1, dx) for dx in (1, -1)]  # launch 1
    n_paths = 3 if num_paths == 8 else 1
    ring = torch.full((2, n_paths, S, w, D), float("nan"))  # never cleared between passes
    n_strips = -(-h // S)
    a_buf = torch.full_like(vol, float("nan"))
    out = torch.full_like(vol, float("nan"))
    fused = num_paths == 8 and order != "k10"

    def rows(strip):
        return slice(strip * S, min(h, strip * S + S))

    def group_sum(strip):
        parts = ring[strip % 2, :, :rows(strip).stop - rows(strip).start]
        return parts[0] if n_paths == 1 else (parts[0] + parts[1]) + parts[2]

    def total(strip, up):
        y = torch.arange(h)[rows(strip)]
        dn, p2, p3, c = a_buf[rows(strip)], horiz[0][rows(strip)], horiz[1][rows(strip)], vol[
            rows(strip)]
        first = (y == 0) & torch.tensor(fused)
        last = (y == h - 1) & torch.tensor(fused)
        if order == "k12":
            hsum = p2 + p3
            acc = torch.where(first[:, None, None], fma3(c, hsum), hsum + dn)
            return torch.where(last[:, None, None], fma3(c, acc), acc + up)
        vert = torch.where(last[:, None, None], fma3(c, dn), dn + up)
        return (vert + p2) + p3 if order == "wdh" else vert + (p2 + p3)

    # launches 2 and 3: the down pass from the top strip, the up pass from the bottom
    for group, strips in (("down", range(n_strips)), ("up", range(n_strips - 1, -1, -1))):
        strips = list(strips)
        for k in range(n_strips + 1):  # phase k: walk strip k, combine strip k - 1
            if k < n_strips:
                for j, (_, dy, dx) in enumerate(GROUPS[group][:n_paths]):
                    _walk_strip(vol, p2_y, p1, ring, j, strips[k], S, dy, dx)
            if k > 0:
                s = strips[k - 1]
                if group == "down":
                    a_buf[rows(s)] = group_sum(s)
                else:
                    out[rows(s)] = total(s, group_sum(s))
    return out


def _inputs(h, w, D, seed):
    r = np.random.default_rng(seed)
    vol = r.uniform(0.0, 60.0, (h, w, D)).astype(np.float32)
    vol[0] = np.round(vol[0])  # integer costs: exact ties in the sums
    img = torch.from_numpy(r.uniform(0, 255, (h, w)).astype(np.float32))
    p2_y, p2_x = p2_maps((h, w), 32.0, torch.float32, torch.device("cpu"), img, True, 8.0)
    return torch.from_numpy(vol), p2_y, p2_x


def _held_to_plain(h, w, D, num_paths, order, S, seed=0):
    vol, p2_y, p2_x = _inputs(h, w, D, seed)
    got = emulate_strips(vol, p2_y, p2_x, 4.0, num_paths, order, S)
    want = aggregate_paths_float(vol, p2_y, p2_x, 4.0, num_paths, ALL_SWEEPS, order)
    assert torch.equal(got, want), (got.double() - want.double()).abs().max().item()


# ---- the schedule against the plain twin -------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 16])
@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("order", ORDERS)
def test_strip_walk_is_the_plain_twin(order, num_paths, S):
    """19 rows (no S divides it; two strips at S = 16) of 11 columns (W < S
    at S = 16: diagonals leave through the side inside a strip), D = 8."""
    _held_to_plain(19, 11, 8, num_paths, order, S)


@pytest.mark.parametrize("S", [3, 16])
@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("order", ORDERS)
def test_strip_walk_one_short_strip(order, num_paths, S):
    """H = 5 < S = 16 (one strip, shorter than S), and three strips of 3, 3
    and 2 rows at S = 3; D = 48 (6 lanes of 8)."""
    _held_to_plain(5, 23, 48, num_paths, order, S, seed=1)


@pytest.mark.parametrize("h,w,S", [(7, 9, 2), (1, 13, 16), (20, 1, 3), (33, 4, 16)])
@pytest.mark.parametrize("order", ["k7", "k12"])
def test_strip_walk_edge_shapes(h, w, S, order):
    """D = 64; one row (both fused rows of k12 on it), one column (every
    diagonal segment a single pixel), three strips of 16, 16 and 1 rows."""
    _held_to_plain(h, w, 64, 8, order, S, seed=h + w)


def test_segments_cover_each_strip_once():
    """Every pixel of a strip lies on exactly one segment of each path, each
    step of a segment moves by (dy, dx) inside the strip, and a segment is
    carried exactly where the pixel one step back lies in the image."""
    for h, w, S in ((19, 11, 16), (5, 23, 3), (40, 7, 8), (9, 1, 2)):
        for strip in range(-(-h // S)):
            y0, y1 = strip * S, min(h, strip * S + S)
            for _, dy, dx in GROUPS["down"] + GROUPS["up"]:
                y, x, length, py, px, carried = segments(h, w, S, strip, dy, dx)
                seen = np.zeros((h, w), int)
                for i in range(len(y)):
                    t = np.arange(length[i])
                    yy, xx = y[i] + dy * t, x[i] + dx * t
                    assert ((yy >= y0) & (yy < y1) & (xx >= 0) & (xx < w)).all()
                    seen[yy, xx] += 1
                    inside = 0 <= y[i] - dy < h and 0 <= x[i] - dx < w
                    assert carried[i] == inside
                    if carried[i]:  # the predecessor lies in the strip walked before
                        assert not y0 <= py[i] < y1
                assert (seen[y0:y1] == 1).all() and seen.sum() == (y1 - y0) * w


def test_strip_walk_is_the_jax_reference():
    """The emulation against the reference's Pallas kernels in interpret mode
    (k7: ``sgm_aggregate_pallas_hdw``; wdh: ``sgm_extract_fused_wdh``'s sum,
    through its extraction), 8 paths, S = 3 over 10 rows."""
    import jax.numpy as jnp

    from stereovisionarray_tpu.ops import sgm_pallas as sp
    from stereovisionarray_tpu_torch.ops.extract_cuda import extract_disparity_maps

    h, w, D = 10, 12, 8
    r = np.random.default_rng(3)
    vol = r.uniform(0, 60, (h, w, D)).astype(np.float32)
    img = r.uniform(0, 255, (h, w)).astype(np.float32)
    p2_y, p2_x = p2_maps((h, w), 32.0, torch.float32, torch.device("cpu"), torch.from_numpy(img),
                         True, 8.0)
    hdw = jnp.moveaxis(jnp.asarray(vol), -1, 1)
    want = np.moveaxis(np.asarray(sp.sgm_aggregate_pallas_hdw(
        hdw, 4.0, 32.0, 8, jnp.asarray(img), True, 8.0, interpret=True)), 1, -1)
    got = emulate_strips(torch.from_numpy(vol), p2_y, p2_x, 4.0, 8, "k7", 3)
    np.testing.assert_array_equal(got.numpy(), want)
    want = sp.sgm_extract_fused_wdh(hdw, None, 4.0, 32.0, 8, jnp.asarray(img), True, 8.0, True,
                                    0.0, 0.0, interpret=True)
    maps = extract_disparity_maps(emulate_strips(torch.from_numpy(vol), p2_y, p2_x, 4.0, 8,
                                                 "wdh", 3), True, 0.0, 0.0)
    for name in ("disparity", "cost", "valid", "second"):
        np.testing.assert_array_equal(getattr(maps, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


# ---- the plan ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape,S,mib", [((540, 768, 64), 16, 18.0),
                                         ((270, 360, 128), 16, 16.875),
                                         ((540, 768, 256), 4, 18.0)])
def test_strip_plan_at_the_float_paths(shape, S, mib):
    """The two-view float32 frame, the array's ZNCC volume, and D = 256."""
    h, w, D = shape
    for num_paths in (4, 8):
        assert _strip_plan(h, w, D, num_paths, ALL_SWEEPS, True) == S
    assert 2 * 3 * S * w * D * 4 / 2**20 == mib


@pytest.mark.parametrize("case", ["sweep_subset", "d_not_a_multiple_of_8", "unaligned"])
def test_strip_plan_refusals_take_the_generic_form(case):
    sweeps = ("down", "up") if case == "sweep_subset" else ALL_SWEEPS
    D = 60 if case == "d_not_a_multiple_of_8" else 64
    assert _strip_plan(540, 768, D, 8, sweeps, case != "unaligned") is None


@pytest.mark.parametrize("D", [8, 48, 64, 128, 256])
def test_strip_plan_invariants(D):
    for w in (1, 11, 360, 768, 1024, 4096):
        S = _strip_plan(100, w, D, 8, ALL_SWEEPS, True)
        assert S in (1, 2, 4, 8, 16, 32) and S <= MAX_STRIP_ROWS
        ring = lambda rows: 2 * 3 * rows * w * D * 4  # noqa: E731
        assert ring(S) <= STRIP_RING_BYTES or S == 1
        assert S == MAX_STRIP_ROWS or ring(2 * S) > STRIP_RING_BYTES


def test_chip_smoke_strip_rows_have_a_plan():
    """chip_smoke.py's strip-route parity shapes all take the strip route."""
    for (h, w, D), orders in chip_smoke.K7_STRIP_ROWS:
        assert orders and _strip_plan(h, w, D, 8, ALL_SWEEPS, True) is not None


# ---- the route ---------------------------------------------------------------------------

def _launched(monkeypatch, vol, num_paths=8, sweeps=ALL_SWEEPS, order="k7", fn=None):
    """The entry points a float sum launches for a CPU volume, the backend
    resolved to "cuda", the CUDA check and the launch stood in for."""
    seen = []
    monkeypatch.setattr(_native, "check", lambda *a: None)
    monkeypatch.setattr(_native, "launch", lambda name, device, *args: seen.append((name, args)))
    monkeypatch.setattr(sgm_cuda, "resolve_backend", lambda t, b="auto": "cuda")
    for wrapper in (sgm_cuda.sgm_aggregate_float, sgm_cuda.sgm_aggregate_hwd,
                    sgm_cuda.sweep_pair, sgm_cuda.sgm_extract_fused):
        for counter in [c for c in vars(wrapper) if c.endswith("launches")]:
            monkeypatch.setattr(wrapper, counter, getattr(wrapper, counter))  # restored after
    h, w, _ = vol.shape
    p2 = torch.full((h, w), 32.0)
    if fn is None:
        sgm_cuda.sgm_aggregate_float(vol, p2, p2, 4.0, num_paths, sweeps, order)
    else:
        fn(vol, p2)
    return seen


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("num_paths", [4, 8])
def test_full_sweeps_launch_the_strip_route(monkeypatch, order, num_paths):
    h, w, D = 21, 40, 16
    vol = torch.zeros((h, w, D))
    launches = (sgm_cuda.sgm_aggregate_float.launches,
                sgm_cuda.sgm_aggregate_float.generic_launches)
    (name, args), = _launched(monkeypatch, vol, num_paths, order=order)
    assert name == "svt_sgm_float_strips"
    assert args[8:] == (h, w, D, 4.0, num_paths, ORDERS.index(order),
                        _strip_plan(h, w, D, num_paths, ALL_SWEEPS, True))
    assert (sgm_cuda.sgm_aggregate_float.launches - launches[0],
            sgm_cuda.sgm_aggregate_float.generic_launches - launches[1]) == (1, 0)


@pytest.mark.parametrize("case", ["sweep_subset", "d_12", "unaligned"])
def test_the_rest_launch_the_generic_form(monkeypatch, case):
    h, w, D = 9, 20, 12 if case == "d_12" else 16
    base = torch.zeros(h * w * D + 1)
    vol = base[1:].view(h, w, D) if case == "unaligned" else base[:-1].view(h, w, D)
    sweeps = ("down", "lr") if case == "sweep_subset" else ALL_SWEEPS
    generic = sgm_cuda.sgm_aggregate_float.generic_launches
    names = [n for n, _ in _launched(monkeypatch, vol, sweeps=sweeps)]
    assert names == ["svt_sgm_paths_f32", "svt_sgm_combine_f32"]
    assert sgm_cuda.sgm_aggregate_float.generic_launches == generic + 1


def test_k10_k12_take_the_strip_route_and_k11_the_generic_form(monkeypatch):
    vol = torch.zeros((12, 30, 32))
    runs = {
        "k10": lambda v, p2: sgm_cuda.sgm_aggregate_hwd(v, 8.0, 96.0, 8),
        "k12": lambda v, p2: sgm_cuda.sgm_extract_fused(v, p2, p2, 8.0, 8, True, 0.95, 1.5),
        "k11": lambda v, p2: sgm_cuda.sweep_pair(v, p2, 8.0, True),
    }
    from stereovisionarray_tpu_torch.ops import extract_cuda

    monkeypatch.setattr(extract_cuda, "resolve_backend", lambda t, b="auto": "cuda")
    seen = {k: [n for n, _ in _launched(monkeypatch, vol, fn=fn)] for k, fn in runs.items()}
    assert seen["k10"] == ["svt_sgm_float_strips"]
    assert seen["k12"] == ["svt_sgm_float_strips", "svt_extract_maps"]
    assert seen["k11"] == ["svt_sgm_paths_f32", "svt_sgm_combine_f32", "svt_sgm_combine_f32"]
