"""The integer SGM scans (K2/K3) as the kernel schedules them, on the CPU.

The kernel pairs the paths into four families of the same lines walked both
ways (down/up, left->right/right->left, down-right/up-left,
down-left/up-right) and sums into int16 with wrap: every walk runs at once
into a buffer of its own (the horizontal family as two walks, one each way),
then a sum pass adds the partials into the total.
Here a numpy walk of that schedule, with the kernel's own line starts and
lengths, is held to the plain twin ``ops/sgm.aggregate_paths``; the
twin's int16 wrap is held to the reference's Pallas sweeps (interpret mode)
where the 8-path total passes 32767; and the wrappers of K2/K3 and K8 refuse
what their kernels do not take before anything is built."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.ops.sgm_pallas import sgm_aggregate_pallas_hdw
from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.ops import sgm as port
from stereovisionarray_tpu_torch.ops import sgm_cuda, sweep_cuda

BIG = port.BIG_INT
# family -> (forward path id, the p2 map it reads): csrc/sgm_paths.cu kFamilyPath
FAMILIES = ((0, "y"), (2, "x"), (4, "y"), (5, "y"))


def family_lines(fam, h, w):
    """(start (y, x), length) of every line of a family, forward direction,
    as csrc/sgm_paths.cu's family_line computes them."""
    dy, dx = port.PATH_STEPS[FAMILIES[fam][0]]
    n = w if fam == 0 else (h if fam == 1 else h + w - 1)
    lines = []
    for line in range(n):
        y_edge, x_edge = (0 if dy > 0 else h - 1), (0 if dx > 0 else w - 1)
        if dx == 0:
            y, x = y_edge, line
        elif dy == 0:
            y, x = line, x_edge
        elif line < w:
            y, x = y_edge, line
        else:
            y, x = y_edge + dy * (line - w + 1), x_edge
        if fam == 0:
            length = h
        elif fam == 1:
            length = w
        else:
            length = min(h - y, w - x if dx > 0 else x + 1)
        lines.append(((y, x), length))
    return lines


def _walk(cost, p2, p1, pixels):
    """L along `pixels` (a list of (y, x)) in int32, the recurrence of
    ops/sgm._step_int with BIG at d = -1 and d = D."""
    out, prev = [], None
    for y, x in pixels:
        c = cost[y, x].astype(np.int64)
        if prev is None:
            cur = c
        else:
            m = prev.min()
            lo = np.concatenate([[BIG], prev[:-1]])
            hi = np.concatenate([prev[1:], [BIG]])
            cur = c + np.minimum(np.minimum(prev, m + p2[y, x]), np.minimum(lo, hi) + p1) - m
        out.append(cur)
        prev = cur
    return out


def kernel_schedule(cost, p2_y, p2_x, p1, num_paths):
    """The int16 total as the kernel's launches compute it."""
    h, w, D = cost.shape
    wrap = lambda a: a.astype(np.int64).astype(np.int16)  # noqa: E731  (int16 storage)
    n_parts = sgm_cuda.scratch_partials(num_paths)
    bufs = {name: np.zeros((h, w, D), np.int16) for name in ["total"] + list(range(n_parts))}

    def walk(fam, passes, out):
        """One family's lines, forward (pass 0), back (1) or both; the first
        pass writes, the second adds to `out`."""
        path = FAMILIES[fam][0]
        dy, dx = port.PATH_STEPS[path]
        p2 = p2_y if FAMILIES[fam][1] == "y" else p2_x
        covered = np.zeros((h, w), np.int64)
        for (y, x), length in family_lines(fam, h, w):
            pix = [(y + i * dy, x + i * dx) for i in range(length)]
            assert all(0 <= py < h and 0 <= px < w for py, px in pix)
            for py, px in pix:
                covered[py, px] += 1
            for p in passes:
                order = pix if p == 0 else pix[::-1]
                for (py, px), L in zip(order, _walk(cost, p2, p1, order)):
                    base = 0 if p == passes[0] else bufs[out][py, px].astype(np.int64)
                    bufs[out][py, px] = wrap(base + L)
        assert (covered == 1).all()  # a family's lines cover every pixel once

    walk(0, (0, 1), "total")  # every walk at once into its own buffer
    walk(1, (0,), 0)
    walk(1, (1,), 1)
    if num_paths == 8:
        walk(2, (0, 1), 2)
        walk(3, (0, 1), 3)
    # the sum pass
    return wrap(sum(bufs[j].astype(np.int64) for j in ["total"] + list(range(n_parts))))


@pytest.mark.parametrize("num_paths", [4, 8])
@pytest.mark.parametrize("h,w,D", [(1, 9, 5), (7, 1, 4), (6, 9, 7), (5, 4, 16), (3, 5, 136)])
def test_family_schedule_reproduces_the_path_sum(h, w, D, num_paths):
    rng = np.random.default_rng(h * 100 + w * 10 + D)
    cost = rng.integers(0, 3000, (h, w, D)).astype(np.int16)  # 8-path totals wrap
    p2_y = rng.integers(20, 400, (h, w)).astype(np.int16)
    p2_x = rng.integers(20, 400, (h, w)).astype(np.int16)
    want = port.aggregate_paths(torch.from_numpy(cost), torch.from_numpy(p2_y),
                                torch.from_numpy(p2_x), 30, num_paths)
    np.testing.assert_array_equal(kernel_schedule(cost, p2_y, p2_x, 30, num_paths), want.numpy())


@pytest.mark.parametrize("num_paths", [4, 8])
def test_int16_total_wraps_as_the_reference(num_paths):
    """Large int16 costs: the int32 path sum passes 32767 and the stored
    int16 total is that sum modulo 2^16, equal to the reference's sweeps."""
    h, w, D = 9, 13, 8
    rng = np.random.default_rng(num_paths)
    vol = rng.integers(4000, 9000, (h, w, D)).astype(np.int16)
    image = rng.uniform(0, 255, (h, w)).astype(np.float32)
    want = sgm_aggregate_pallas_hdw(jnp.moveaxis(jnp.asarray(vol), -1, 1), 32, 384, num_paths,
                                    jnp.asarray(image), True, 96, interpret=True)
    want = np.moveaxis(np.asarray(want), 1, -1)
    p2_y, p2_x = port.p2_maps((h, w), 384, torch.int16, "cpu", torch.from_numpy(image), True, 96)
    got = port.aggregate_paths(torch.from_numpy(vol), p2_y, p2_x, 32, num_paths)
    wide = port.aggregate_paths(torch.from_numpy(vol).to(torch.int32), p2_y, p2_x, 32, num_paths)
    assert int(wide.max()) > 32767  # the case the int16 accumulation relies on
    assert torch.equal(wide.to(torch.int16), got)
    np.testing.assert_array_equal(got.numpy(), want)


def _int_vol(D=16, dtype=torch.int8):
    return torch.zeros((4, 6, D), dtype=dtype)


def _p2():
    return torch.zeros((4, 6), dtype=torch.int16)


def _sweep_args(S=4, D=3):
    return torch.zeros((10, 12)), torch.zeros((S, 10, 12)), torch.zeros((D, S, 2))


@pytest.mark.parametrize("call,error,message", [
    (lambda: sgm_cuda.sgm_aggregate_paths(_int_vol(), _p2(), _p2(), 8, 8, "cuda"), ValueError,
     "needs a CUDA tensor"),
    (lambda: sgm_cuda.sgm_aggregate_paths(_int_vol(dtype=torch.float32), _p2(), _p2(), 8),
     TypeError, "int8 or int16 costs"),
    (lambda: sgm_cuda._launch_int(_int_vol(), _p2(), _p2(), 8, 8), ValueError,
     "vol must be a CUDA tensor"),
    (lambda: sgm_cuda._launch_int(_int_vol(D=257), _p2(), _p2(), 8, 8), ValueError,
     r"num_disparities must be in \[3, 256\]"),
    (lambda: sgm_cuda._launch_int(_int_vol(D=2), _p2(), _p2(), 8, 8), ValueError,
     r"num_disparities must be in \[3, 256\]"),
    (lambda: sgm_cuda._launch_int(_int_vol(), _p2(), _p2(), 8, 6), ValueError,
     "num_paths must be 4 or 8"),
    (lambda: sweep_cuda.plane_sweep_census(*_sweep_args(), patch=5, backend="cuda"), ValueError,
     "needs a CUDA tensor"),
    (lambda: sweep_cuda.plane_sweep_census(*_sweep_args(), patch=4), ValueError,
     "patch must be odd"),
    (lambda: sweep_cuda.plane_sweep_census(*_sweep_args(), patch=1), ValueError,
     "patch must be odd"),
    (lambda: sweep_cuda.plane_sweep_census(*_sweep_args(), topk=4), ValueError,
     r"topk must be in \[1, n_views\)"),
    (lambda: sweep_cuda.plane_sweep_census(*_sweep_args(), topk=0), ValueError,
     r"topk must be in \[1, n_views\)"),
    (lambda: sweep_cuda.plane_sweep_census(*_sweep_args(), valid_mean=True, topk=2), ValueError,
     "exclusive"),
], ids=["k23_cpu_tensor", "k23_float_costs", "k23_launch_cpu", "k23_d257", "k23_d2",
        "k23_paths6", "k8_cpu_tensor", "k8_even_patch", "k8_patch1", "k8_topk_ge_s",
        "k8_topk0", "k8_topk_and_mean"])
def test_wrappers_refuse_before_building(monkeypatch, call, error, message):
    monkeypatch.setattr(_native, "build", lambda force=False: pytest.fail("built"))
    with pytest.raises(error, match=message):
        call()
