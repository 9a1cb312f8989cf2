"""The extraction kernel's tiled schedule (K4 / K6, ``csrc/extract.cu``), on the CPU.

The kernel stages a tile of C columns of a row, and R = D - 1 halo columns
when it computes the right view, in shared memory at a padded column stride
of P 32-bit words, then runs each column's per-pixel loop on the staged copy;
with the LR check a row is one cluster of CTAs that read each other's d_R.
Here the plan (``ops/extract_cuda._tile_plan``) is held to its invariants and
to the main paths' shapes, and a numpy walk of the schedule is held bit for
bit to the plain twin ``extract_maps_plain``: it takes the tile and stride
the wrapper launches with, stages each tile in the kernel's two forms (16
bytes a thread, an element a thread) into a word buffer of stale contents,
and computes each pixel from that buffer with the kernel's indexing and
float32 arithmetic."""

import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.ops import extract_cuda
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    BIG_FLOAT,
    LR_CTAS,
    MAX_LR_WIDTH,
    SMEM_LIMIT,
    TILES,
    _tile_plan,
    extract_maps_plain,
)
from stereovisionarray_tpu_torch.ops.sgm import BIG_INT

F32 = np.float32
SIZES = {"int8": 1, "int16": 2, "int16_wrapped": 2, "float32": 4}


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("D", [3, 5, 48, 64, 97, 128, 256, 300])
def test_tile_plan_invariants(D, size):
    for w in (1, 7, 127, 128, 300, 768, 1024, 1100, 4097, MAX_LR_WIDTH):
        for right_view, lr in ((False, False), (True, False), (True, True)):
            p = _tile_plan(w, D, size, right_view, lr)
            assert p.stride_words % 2 == 1 and 4 * p.stride_words >= D * size
            assert p.stride_words == _ceil(D * size, 4) | 1
            assert p.halo == (D - 1 if right_view else 0)
            assert p.per_row * p.cols >= w and (p.per_row - 1) * p.cols < w
            row_r = 4 * p.cols if lr else 0
            if lr:
                assert p.per_row <= LR_CTAS and p.cols == _ceil(w, p.per_row)
            if p.tiled:
                assert p.tile in TILES and p.smem_bytes <= SMEM_LIMIT
                assert p.smem_bytes == (p.tile + p.halo) * 4 * p.stride_words + row_r
                wider = [t for t in TILES if t > p.tile]  # the widest tile that fits
                assert all((t + p.halo) * 4 * p.stride_words + row_r > SMEM_LIMIT for t in wider)
                if not lr:
                    assert p.cols == p.tile
            else:
                assert p.tile == 0 and p.smem_bytes == row_r
                assert (TILES[-1] + p.halo) * 4 * p.stride_words + row_r > SMEM_LIMIT


# the main paths' extraction: (w, D, element size, right view, LR) -> (R, P, C, smem)
MAIN_PATHS = {
    "two_view_int8_int16_bench": ((768, 64, 2, True, True), (63, 33, 128, 25724)),
    "two_view_entry": ((384, 64, 2, True, True), (63, 33, 128, 25724)),
    "two_view_float32": ((768, 64, 4, True, True), (63, 65, 128, 50172)),
    "flat_d256": ((768, 256, 2, True, True), (255, 129, 128, 198140)),
    "array_k4_no_right_view": ((360, 128, 2, False, False), (0, 65, 128, 33280)),
    "array_no_sgm_k6": ((360, 128, 1, False, False), (0, 33, 128, 16896)),
    "array_zncc_k6": ((360, 128, 4, False, False), (0, 129, 128, 66048)),
}


@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_tile_plan_at_the_main_paths(path):
    args, (R, P, C, smem) = MAIN_PATHS[path]
    p = _tile_plan(*args)
    assert p.tiled and (p.halo, p.stride_words, p.tile, p.smem_bytes) == (R, P, C, smem)
    assert (p.per_row, p.cols) == (_ceil(args[0], 128), 128)  # a tile a CTA at these widths


def test_card_suite_rows_are_tiled_but_for_the_generic_one():
    """The card suite's extraction rows: each path's is tiled, the last
    (float32, D = 256, LR) is the generic form's."""
    for row, kernel, (h, w, D), vtype, lr in torch_records.EXTRACT_ROWS:
        p = _tile_plan(w, D, SIZES[vtype], lr, lr)
        assert p.tiled == (row != "float32_d256_lr"), row


def test_float32_d256_with_lr_runs_the_generic_form():
    p = _tile_plan(768, 256, 4, True, True)
    assert not p.tiled and p.tile == 0 and (p.halo, p.stride_words) == (255, 257)
    assert (p.per_row, p.cols, p.smem_bytes) == (6, 128, 512)  # the generic form's d_R
    assert _tile_plan(768, 256, 4, False, False).tiled  # no halo: 131584 bytes


def _launch_args(monkeypatch, total, lr, right):
    """The arguments ``_launch_maps`` hands ``svt_extract_maps`` for a CPU
    volume, the CUDA check and the launch stood in for."""
    seen = []
    monkeypatch.setattr(_native, "check", lambda *a: None)
    monkeypatch.setattr(_native, "launch", lambda name, device, *args: seen.append((name, args)))
    extract_cuda._launch_maps(total, True, 0.95, lr, right)
    (name, args), = seen
    assert name == "svt_extract_maps"
    return args


@pytest.mark.parametrize("shape,dtype,lr,right", [
    ((540, 768, 64), torch.int16, 1.5, False), ((4, 768, 256), torch.float32, 1.5, False),
    ((4, 360, 128), torch.int8, 0.0, False), ((4, 768, 256), torch.float32, 0.0, True),
])
def test_wrapper_launches_with_the_plan(monkeypatch, shape, dtype, lr, right):
    total = torch.zeros(shape, dtype=dtype)
    args = _launch_args(monkeypatch, total, lr, right)
    h, w, D = shape
    p = _tile_plan(w, D, total.element_size(), lr > 0 or right, lr > 0)
    assert args[:6] == (total.data_ptr(), total.element_size(), h, w, D, 1)
    assert args[8:10] == (p.tile, p.stride_words)


def _stage(words, span, P, form):
    """The kernel's staging of `span`, (n_cols, D) columns of a row, into the
    word buffer: column j at word j * P."""
    n_cols, D = span.shape
    raw = np.ascontiguousarray(span).view(np.uint8).reshape(-1)
    if form == "16_bytes":  # chunk q of 16 bytes -> four words of column q // chunks
        chunks = D * span.itemsize // 16
        q = np.arange(n_cols * chunks)
        j, b = q // chunks, q % chunks
        quads = raw.view(np.uint32).reshape(-1, 4)
        for k in range(4):
            words[j * P + b * 4 + k] = quads[:, k]
    else:  # element e -> element (e // D) * stride + e % D
        stride = 4 * P // span.itemsize
        e = np.arange(n_cols * D)
        j = e // D
        words.view(span.dtype)[j * stride + e - j * D] = span.reshape(-1)


def _subpixel(d_int, D, fm, f0, fp):
    """csrc/extract.cu::subpixel in float32."""
    d_c = np.clip(d_int, 1, D - 2)
    denom = (fm - F32(2) * f0) + fp
    nonflat = np.abs(denom) > F32(1e-9)
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(nonflat, (fm - fp) / (F32(2) * denom), F32(0))
    delta = np.minimum(np.maximum(delta, F32(-0.5)), F32(0.5))
    interior = (d_int >= 1) & (d_int <= D - 2)
    return np.where(interior, d_c.astype(F32) + delta, d_int.astype(F32)).astype(F32)


def _walk(total, plan, form, subpixel, uniqueness, lr_max_diff, right):
    """The tiled kernel's schedule over an (H, W, D) numpy volume: maps as
    ``extract_maps_plain`` returns them."""
    h, w, D = total.shape
    C, R, P = plan.tile, plan.halo, plan.stride_words
    stride = 4 * P // total.itemsize
    lr = lr_max_diff > 0
    right_view = lr or right
    assert R == (D - 1 if right_view else 0)
    integer = total.dtype != np.float32
    ctype = np.int64 if integer else F32
    big = ctype(BIG_INT if integer else BIG_FLOAT)
    disp, cost, second, disp_r = (np.full((h, w), np.nan, F32) for _ in range(4))
    valid = np.zeros((h, w), bool)
    stale = np.random.default_rng(7)
    d = np.arange(D)
    for y in range(h):
        row_r = np.full((plan.per_row, plan.cols), np.nan, F32)
        for c in range(plan.per_row):
            x0 = c * plan.cols
            x1 = min(x0 + plan.cols, w)
            for t0 in range(x0, x1, C):
                n_cols = min(min(t0 + C, x1) + R, w) - t0
                words = stale.integers(0, 2**32, (C + R) * P, dtype=np.uint64).astype(np.uint32)
                _stage(words, total[y, t0:t0 + n_cols], P, form)
                staged = words.view(total.dtype)
                i = np.arange(min(C, x1 - t0))
                x = t0 + i
                a = staged[i[:, None] * stride + d].astype(ctype)
                bd = a.argmin(axis=1)  # the first minimum: the smallest d
                best = a[i, bd]
                far = np.abs(d - bd[:, None]) > 1
                sec = np.where(far, a, big).min(axis=1)
                dc = np.clip(bd, 1, D - 2)
                c_best = best.astype(F32)
                disp[y, x] = (_subpixel(bd, D, a[i, dc - 1].astype(F32), c_best,
                                        a[i, dc + 1].astype(F32)) if subpixel
                              else bd.astype(F32))
                cost[y, x] = c_best
                second[y, x] = sec.astype(F32)
                valid[y, x] = (c_best < F32(uniqueness) * sec.astype(F32) if uniqueness > 0
                               else True)
                if not right_view:
                    continue
                inside = d < np.minimum(D, w - x)[:, None]  # x + d < W
                ridx = i[:, None] * stride + d * (stride + 1)  # column i + d, element d
                assert (ridx[inside] < n_cols * stride).all()  # only staged columns are read
                rv = np.where(inside, staged[np.where(inside, ridx, 0)].astype(ctype), big)
                rbd = rv.argmin(axis=1)
                rdc = np.clip(rbd, 1, D - 2)
                dr = (_subpixel(rbd, D, rv[i, rdc - 1].astype(F32), rv[i, rbd].astype(F32),
                                rv[i, rdc + 1].astype(F32)) if subpixel else rbd.astype(F32))
                if lr:
                    row_r[c, x - x0] = dr
                if right:
                    disp_r[y, x] = dr
        if lr:  # each pixel reads d_R(x - rint d_L) from the CTA that owns that column
            x = np.arange(w)
            src = x - np.clip(np.rint(disp[y]).astype(np.int64), 0, D - 1)
            inside = src >= 0
            owner = np.where(inside, src, 0) // plan.cols
            at = np.where(inside, row_r[owner, np.where(inside, src, 0) - owner * plan.cols],
                          F32(BIG_FLOAT))
            valid[y] &= (np.abs(disp[y] - at) <= F32(lr_max_diff)) & (at < F32(BIG_FLOAT))
    return disp, cost, valid, second, (disp_r if right else None)


def _volume(rng, h, w, D, kind):
    """A volume with exact ties, winners at both ends and, but for int8,
    costs above BIG; `int16_wrapped` spans int16 (an 8-path total that wrapped)."""
    if kind == "float32":
        a = rng.uniform(10.0, 400.0, (h, w, D)).astype(F32)
        big = 2e9
    elif kind == "int16_wrapped":
        a = rng.integers(-32768, 32768, (h, w, D)).astype(np.int16)
        big = 16500
    else:
        a = rng.integers(20, 120 if kind == "int8" else 400, (h, w, D)).astype(kind)
        big = None if kind == "int8" else 16500
    a[0, :, 1] = a[0, :, D - 1] = 10
    a[1 % h, :, D - 1] = 5
    if big is not None:
        a[-1, : w // 2] = big
    return a


def _held_to_plain(monkeypatch, vol, lr, right):
    total = torch.from_numpy(vol)
    h, w, D = vol.shape
    args = _launch_args(monkeypatch, total, lr, right)
    plan = _tile_plan(w, D, vol.itemsize, lr > 0 or right, lr > 0)
    assert plan.tiled and args[8:10] == (plan.tile, plan.stride_words)
    forms = ["element"] + (["16_bytes"] if D * vol.itemsize % 16 == 0 else [])
    for subpixel, uniqueness in ((True, 0.95), (False, 0.95), (True, 0.0)):
        want = extract_maps_plain(total, subpixel, uniqueness, lr, right)
        for form in forms:
            got = _walk(vol, plan, form, subpixel, uniqueness, lr, right)
            for g, t in zip(got, want):
                if t is None:
                    assert g is None
                    continue
                assert torch.equal(torch.from_numpy(g), t), (form, subpixel, uniqueness)
    return plan


@pytest.mark.parametrize("lr,right", [(1.5, False), (0.0, True)])
@pytest.mark.parametrize("D,tile", [(200, 64), (220, 32)])
def test_narrow_tile_walk_is_the_plain_twin(monkeypatch, D, tile, lr, right):
    """float32 with the right view at D = 200 and 220: 64 and 32 columns a
    tile, several tiles a CTA."""
    vol = _volume(np.random.default_rng(D), 2, 150, D, "float32")
    assert _held_to_plain(monkeypatch, vol, lr, right).tile == tile


@pytest.mark.parametrize("lr,right", [(1.5, False), (1.5, True), (0.0, True), (0.0, False)])
@pytest.mark.parametrize("kind", sorted(SIZES))
@pytest.mark.parametrize("h,w,D", [
    (3, 40, 16),  # W < C
    (3, 7, 48),  # W < D
    (2, 300, 8),  # W not a multiple of C
    (2, 1100, 5),  # W > 8 * 128: with LR two tiles a CTA
    (1, 2500, 9),  # three tiles a CTA with LR
    (3, 50, 3),  # D = 3
    (2, 150, 97),  # D = 97
    (2, 200, 64),  # D * size a multiple of 16 for every type
])
def test_tiled_walk_is_the_plain_twin(monkeypatch, h, w, D, kind, lr, right):
    vol = _volume(np.random.default_rng(h * 1000 + w + D), h, w, D, kind)
    _held_to_plain(monkeypatch, vol, lr, right)
