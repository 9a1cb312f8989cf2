"""The extraction kernel's staged schedules (K4 / K6, ``csrc/extract.cu``), on the CPU.

The tiled form stages a tile of C columns of a row, and R = D - 1 halo
columns when it computes the right view, in shared memory at a padded column
stride of P 32-bit words, then runs each column's per-pixel loop on the
staged copy; with the LR check a row is one cluster of CTAs that read each
other's d_R. The split form (an integer volume's right view whose halo would
leave an SM one CTA) stages each column once, into a ring of C-column slots,
folds each staged candidate into its CTA's packed partial minimum of the
right pixel it belongs to, and joins the partials over the row's cluster.
Here the plan (``ops/extract_cuda._tile_plan``) is held to its invariants and
to the main paths' shapes, and a numpy walk of each schedule is held bit for
bit to the plain twin ``extract_maps_plain``: it takes the form, tile and
stride the wrapper launches with, stages each tile in the kernel's forms (16
bytes or 4 bytes a copy, an element a thread) into a word buffer of stale
contents, and computes each pixel from that buffer with the kernel's
indexing, keys and float32 arithmetic."""

import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.ops import extract_cuda
from stereovisionarray_tpu_torch.ops.extract_cuda import (
    BIG_FLOAT,
    FORMS,
    LR_CTAS,
    MAX_LR_WIDTH,
    RING,
    SMEM_LIMIT,
    SPLIT_TILE,
    TILES,
    _tile_plan,
    _two_ctas,
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
    for w in (1, 7, 127, 128, 300, 768, 1024, 1100, 1242, 4097, MAX_LR_WIDTH):
        for right_view, lr in ((False, False), (True, False), (True, True)):
            p = _tile_plan(w, D, size, right_view, lr)
            assert p.form in FORMS and 4 * p.stride_words >= D * size
            if p.form == "split":  # 16-byte aligned, an odd number of 16-byte chunks
                assert p.stride_words == 4 * (_ceil(D * size, 16) | 1)
            else:  # odd
                assert p.stride_words == _ceil(D * size, 4) | 1
            assert p.halo == (D - 1 if right_view and p.form != "split" else 0)
            assert p.per_row * p.cols >= w and (p.per_row - 1) * p.cols < w
            clustered = lr or p.form == "split"
            if clustered:
                assert p.per_row == min(LR_CTAS, _ceil(w, 128)) and p.cols == _ceil(w, p.per_row)
            row_r = 4 * _ceil(w, min(LR_CTAS, _ceil(w, 128))) if lr else 0
            # the tiled form's right view at C = 128, which the split form replaces
            halo_tile = (TILES[0] + D - 1) * 4 * (_ceil(D * size, 4) | 1) + row_r
            cols = _ceil(w, min(LR_CTAS, _ceil(w, 128)))  # a split CTA's
            split = RING * SPLIT_TILE * 16 * (_ceil(D * size, 16) | 1) + row_r + (cols + D - 1) * 4
            if p.form == "split":
                assert size < 4 and right_view and not _two_ctas(halo_tile)
                assert p.tile == SPLIT_TILE and p.smem_bytes == split <= SMEM_LIMIT
            elif size < 4 and right_view:  # the halo leaves two CTAs, or the ring does not fit
                assert _two_ctas(halo_tile) or split > SMEM_LIMIT
            if p.form == "tiled":
                assert p.tile in TILES and p.smem_bytes <= SMEM_LIMIT
                assert p.smem_bytes == (p.tile + p.halo) * 4 * p.stride_words + row_r
                wider = [t for t in TILES if t > p.tile]  # the widest tile that fits
                assert all((t + p.halo) * 4 * p.stride_words + row_r > SMEM_LIMIT for t in wider)
                if not lr:
                    assert p.cols == p.tile
            elif p.form == "generic":
                assert p.tile == 0 and p.smem_bytes == row_r
                assert (TILES[-1] + p.halo) * 4 * p.stride_words + row_r > SMEM_LIMIT


# the main paths' extraction: (w, D, element size, right view, LR) -> (form, R, P, C,
# smem, CTAs a row, columns a CTA)
MAIN_PATHS = {
    "two_view_int8_int16_bench": ((768, 64, 2, True, True), ("tiled", 63, 33, 128, 25724, 6, 128)),
    "two_view_entry": ((384, 64, 2, True, True), ("tiled", 63, 33, 128, 25724, 3, 128)),
    "two_view_float32": ((768, 64, 4, True, True), ("tiled", 63, 65, 128, 50172, 6, 128)),
    "flat_d256": ((768, 256, 2, True, True), ("split", 0, 132, 32, 35836, 6, 128)),
    "two_view_kitti": ((1242, 256, 2, True, True), ("split", 0, 132, 32, 36060, 8, 156)),
    "array_k4_no_right_view": ((360, 128, 2, False, False), ("tiled", 0, 65, 128, 33280, 3, 128)),
    "array_no_sgm_k6": ((360, 128, 1, False, False), ("tiled", 0, 33, 128, 16896, 3, 128)),
    "array_zncc_k6": ((360, 128, 4, False, False), ("tiled", 0, 129, 128, 66048, 3, 128)),
}


@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_tile_plan_at_the_main_paths(path):
    args, want = MAIN_PATHS[path]
    p = _tile_plan(*args)
    assert (p.form, p.halo, p.stride_words, p.tile, p.smem_bytes, p.per_row, p.cols) == want
    assert _two_ctas(p.smem_bytes)  # every main path leaves an SM two CTAs or more


def test_card_suite_rows_are_tiled_but_for_the_generic_one():
    """The card suite's extraction rows: each path's is staged (tiled, or
    split at D = 256 int16 with the LR check), the last (float32, D = 256,
    LR) is the generic form's."""
    for row, kernel, (h, w, D), vtype, lr in torch_records.EXTRACT_ROWS:
        p = _tile_plan(w, D, SIZES[vtype], lr, lr)
        want = ("generic" if row == "float32_d256_lr" else
                "split" if (D, vtype, lr) == (256, "int16", True) else "tiled")
        assert p.form == want, row


@pytest.mark.parametrize("h,w", [(375, 1242), (540, 768)])
@pytest.mark.parametrize("lr,right", [(True, False), (True, True), (False, True)])
def test_the_split_form_takes_the_d256_right_views(h, w, lr, right):
    """KITTI's 375x1242x256 and the flat cascade's 540x768x256 int16 with a
    right view: the split form, six CTAs an SM; without one, the tiled form
    as before (no halo, 66 KB); int8 at D = 256 keeps its halo tile (100 KB,
    two CTAs)."""
    p = _tile_plan(w, 256, 2, right or lr, lr)
    assert p.form == "split" and p.tile == 32 and p.per_row == min(8, _ceil(w, 128))
    assert 6 * (p.smem_bytes + 1024) <= 233472
    assert _tile_plan(w, 256, 2, False, False)[:] == ("tiled", _ceil(w, 128), 128, 128, 0, 129,
                                                      66048)
    assert _tile_plan(w, 256, 1, right or lr, lr).form == "tiled"


def test_float32_d256_with_lr_runs_the_generic_form():
    p = _tile_plan(768, 256, 4, True, True)
    assert p.form == "generic" and p.tile == 0 and (p.halo, p.stride_words) == (255, 257)
    assert (p.per_row, p.cols, p.smem_bytes) == (6, 128, 512)  # the generic form's d_R
    assert _tile_plan(768, 256, 4, False, False).form == "tiled"  # no halo: 131584 bytes


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
    ((4, 1242, 256), torch.int16, 1.25, False), ((4, 768, 256), torch.int16, 0.0, True),
])
def test_wrapper_launches_with_the_plan(monkeypatch, shape, dtype, lr, right):
    total = torch.zeros(shape, dtype=dtype)
    args = _launch_args(monkeypatch, total, lr, right)
    h, w, D = shape
    p = _tile_plan(w, D, total.element_size(), lr > 0 or right, lr > 0)
    assert args[:6] == (total.data_ptr(), total.element_size(), h, w, D, 1)
    assert args[8:11] == (FORMS.index(p.form), p.tile, p.stride_words)


def _stage(words, span, P, form):
    """The kernel's staging of `span`, (n_cols, D) columns of a row, into the
    word buffer: column j at word j * P. `form`: 16 bytes a copy (copy q of
    the span to the four words of chunk q % chunks of column q // chunks), or
    an element a thread."""
    n_cols, D = span.shape
    raw = np.ascontiguousarray(span).view(np.uint8).reshape(-1)
    if form == "16_bytes":
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


def _left_view(a, big, subpixel, uniqueness):
    """csrc/extract.cu::extract_pixel's left view of the (n, D) staged values
    `a` of n columns: (disparity, cost, second, valid)."""
    n, D = a.shape
    i, d = np.arange(n), np.arange(D)
    bd = a.argmin(axis=1)  # the first minimum: the smallest d
    best = a[i, bd]
    sec = np.where(np.abs(d - bd[:, None]) > 1, a, big).min(axis=1)
    dc = np.clip(bd, 1, D - 2)
    c_best = best.astype(F32)
    disp = (_subpixel(bd, D, a[i, dc - 1].astype(F32), c_best, a[i, dc + 1].astype(F32))
            if subpixel else bd.astype(F32))
    valid = c_best < F32(uniqueness) * sec.astype(F32) if uniqueness > 0 else True
    return disp, c_best, sec.astype(F32), valid


def _lr_check(disp, valid, row_r, cols, D, lr_max_diff):
    """The fused LR check of one row: each pixel reads d_R(x - rint d_L) from
    the CTA that owns that column (`row_r`: (CTAs, cols))."""
    x = np.arange(disp.shape[0])
    src = x - np.clip(np.rint(disp).astype(np.int64), 0, D - 1)
    inside = src >= 0
    owner = np.where(inside, src, 0) // cols
    at = np.where(inside, row_r[owner, np.where(inside, src, 0) - owner * cols], F32(BIG_FLOAT))
    valid &= (np.abs(disp - at) <= F32(lr_max_diff)) & (at < F32(BIG_FLOAT))


def _walk(total, plan, form, subpixel, uniqueness, lr_max_diff, right):
    """The tiled kernel's schedule over an (H, W, D) numpy volume: maps as
    ``extract_maps_plain`` returns them."""
    h, w, D = total.shape
    C, R, P = plan.tile, plan.halo, plan.stride_words
    stride = 4 * P // total.itemsize
    lr = lr_max_diff > 0
    right_view = lr or right
    assert plan.form == "tiled" and R == (D - 1 if right_view else 0)
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
                disp[y, x], cost[y, x], second[y, x], valid[y, x] = _left_view(
                    a, big, subpixel, uniqueness)
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
        if lr:
            _lr_check(disp[y], valid[y], row_r, plan.cols, D, lr_max_diff)
    return disp, cost, valid, second, (disp_r if right else None)


def _key(cost, d):
    """csrc/extract.cu::right_key: (cost + 32768) << 16 | d, unsigned."""
    return ((cost.astype(np.int64) + 32768) << 16) | d


def _walk_split(total, plan, form, subpixel, uniqueness, lr_max_diff, right):
    """The split kernel's schedule over an (H, W, D) integer numpy volume:
    each CTA stages its own columns into a ring of slots of stale contents,
    runs the left view of each (the kernel's min of packed keys over two
    halves of a column is order-free: the first minimum), folds each staged
    candidate into the partial key of its right pixel as a warp of 32
    consecutive pixels does, then each right pixel joins the partials of the
    CTAs its window spans."""
    h, w, D = total.shape
    C, P, cols = plan.tile, plan.stride_words, plan.cols
    stride = 4 * P // total.itemsize
    lr = lr_max_diff > 0
    assert plan.form == "split" and plan.halo == 0 and total.dtype != np.float32
    assert cols == _ceil(w, plan.per_row) and (lr or right)
    big = np.int64(BIG_INT)
    no_key = np.int64(2**32 - 1)
    disp, cost, second, disp_r = (np.full((h, w), np.nan, F32) for _ in range(4))
    valid = np.zeros((h, w), bool)
    stale = np.random.default_rng(7)
    d = np.arange(D)
    for y in range(h):
        ring = stale.integers(0, 2**32, (RING, C * P), dtype=np.uint64).astype(np.uint32)
        parts = []  # each CTA's keys of right pixels [xlo, x1)
        for c in range(plan.per_row):
            x0 = c * cols
            x1 = min(x0 + cols, w)
            xlo = max(0, x0 - D + 1)
            part = np.full(x1 - xlo, no_key)
            for t, t0 in enumerate(range(x0, x1, C)):
                n = min(C, x1 - t0)
                words = ring[t % RING]
                _stage(words, total[y, t0:t0 + n], P, form)
                staged = words.view(total.dtype)
                i = np.arange(n)
                a = staged[i[:, None] * stride + d].astype(np.int64)
                x = t0 + i
                disp[y, x], cost[y, x], second[y, x], valid[y, x] = _left_view(
                    a, big, subpixel, uniqueness)
                a_, b_ = max(xlo, t0 - D + 1), t0 + n
                for first in range(a_, b_, 32):  # a warp's 32 right pixels
                    last = min(first + 31, b_ - 1)
                    j = np.arange(max(0, first - t0), min(n, last + D - t0))
                    xr = np.arange(first, last + 1)[:, None]
                    dd = t0 + j[None, :] - xr  # candidate d of pixel xr in column j
                    ok = (dd >= 0) & (dd < D)
                    idx = np.where(ok, j[None, :] * stride + dd, 0)
                    assert (idx[ok] < n * stride).all()  # only the tile's staged columns
                    keys = np.where(ok, _key(staged[idx], dd), no_key)
                    part[xr[:, 0] - xlo] = np.minimum(part[xr[:, 0] - xlo], keys.min(axis=1))
            parts.append((xlo, part))
        row_r = np.full((plan.per_row, cols), np.nan, F32)
        for c in range(plan.per_row):
            x = np.arange(c * cols, min((c + 1) * cols, w))
            n_right = np.minimum(D, w - x)
            key = np.where(n_right < D, _key(big, n_right), no_key)
            for c2 in range(c, plan.per_row):
                xlo, part = parts[c2]
                spans = c2 * cols < x + n_right
                key = np.where(spans, np.minimum(key, part[np.where(spans, x - xlo, 0)]), key)
            rbd = key & 0xFFFF
            rbest = ((key >> 16) - 32768).astype(F32)

            def right_at(dd):
                vals = total[y, np.minimum(x + dd, w - 1), dd].astype(np.int64)
                return np.where(dd < n_right, vals, big).astype(F32)

            rdc = np.clip(rbd, 1, D - 2)
            dr = (_subpixel(rbd, D, right_at(rdc - 1), rbest, right_at(rdc + 1)) if subpixel
                  else rbd.astype(F32))
            row_r[c, : len(x)] = dr
            if right:
                disp_r[y, x] = dr
        if lr:
            _lr_check(disp[y], valid[y], row_r, cols, D, lr_max_diff)
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
    assert args[8:11] == (FORMS.index(plan.form), plan.tile, plan.stride_words)
    walk = {"tiled": _walk, "split": _walk_split}[plan.form]
    forms = ["element"] + (["16_bytes"] if D * vol.itemsize % 16 == 0 else [])
    for subpixel, uniqueness in ((True, 0.95), (False, 0.95), (True, 0.0)):
        want = extract_maps_plain(total, subpixel, uniqueness, lr, right)
        for form in forms:
            got = walk(vol, plan, form, subpixel, uniqueness, lr, right)
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
    assert _held_to_plain(monkeypatch, vol, lr, right).form == "tiled"


@pytest.mark.parametrize("lr,right", [(1.5, False), (1.5, True), (0.0, True)])
@pytest.mark.parametrize("kind,D", [("int16", 256), ("int16_wrapped", 256), ("int16", 255),
                                    ("int8", 384)])
@pytest.mark.parametrize("h,w", [
    (2, 100),  # W < D: one CTA
    (2, 300),  # 3 CTAs of 100 columns: three tiles of 32 and one of 4, windows over 3 CTAs
    (1, 1000),  # 8 CTAs of 125 columns: windows over 4 CTAs
    (1, 1242),  # KITTI's width: 8 CTAs of 156 columns, four tiles of 32 and one of 28
])
def test_split_walk_is_the_plain_twin(monkeypatch, h, w, kind, D, lr, right):
    """The split form's schedule, bit for bit: int16 at D = 256 (also an 8-path
    total that wrapped, and D = 255, staged an element a thread), int8 at
    D = 384, with the LR check and the right map in each combination."""
    vol = _volume(np.random.default_rng(h * 1000 + w + D), h, w, D, kind)
    plan = _held_to_plain(monkeypatch, vol, lr, right)
    assert plan.form == "split" and plan.per_row == min(8, _ceil(w, 128))
