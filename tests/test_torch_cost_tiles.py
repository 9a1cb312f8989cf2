"""The cost volume kernel's tiled schedule (K1, ``csrc/cost_volume.cu``), on the CPU.

A CTA of C threads stages the census window's rows around its row, for its
C left pixels and their D - 1 right halo, edge-clamped, into shared memory;
builds each pixel's census code and BT triple once (a BT neighbour across a
row end read from the image: the wrap); then thread i sweeps pixel x0 + i
over all D disparities in runs of V values, one 8- or 16-byte store each.
Here the plan (``ops/cost_cuda._tile_plan``) is held to its invariants and
to the main paths' shapes, the wrapper to the plan it launches with, and a
numpy walk of the schedule is held bit for bit to the plain twin
``fused_cost_volume``: it lays the plan's shared memory out in a byte buffer
of stale contents, stages, builds and sweeps with the kernel's indexes and
float32 arithmetic, and checks that a warp's shared-memory accesses fall on
distinct banks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stereovisionarray_tpu.ops.cost_pallas import fused_cost_volume_pallas_wdh
from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.ops import cost_cuda
from stereovisionarray_tpu_torch.ops.cost_cuda import (
    SMEM_LIMIT,
    SMS,
    TILES,
    _layout,
    _tile_plan,
    fused_cost_volume_cuda,
)
from stereovisionarray_tpu_torch.ops.cost_volume import (
    cost_scale_for,
    fused_cost_volume,
    worst_cost,
)

F32 = np.float32
SIZES = {"int8": 1, "int16": 2, "float32": 4}


def _words(window):
    return -(-(window[0] * window[1] - 1) // 64)


@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("window", [(7, 9), (5, 7), (15, 17), (3, 1)])
@pytest.mark.parametrize("D", [3, 8, 24, 47, 48, 64, 97, 256, 1024, 4000])
def test_tile_plan_invariants(D, window, size):
    for h, w in ((1, 7), (3, 40), (256, 384), (540, 768), (135, 192), (1000, 4097)):
        p = _tile_plan(h, w, D, window, size)
        if D * size % 8:
            assert p is None
            continue
        fits = [t for t in TILES if _layout(t, D, window, size, w).smem_bytes <= SMEM_LIMIT]
        if not fits:
            assert p is None
            continue
        assert p is not None and p.tile in fits and p.smem_bytes <= SMEM_LIMIT
        # the widest tile whose full tiles keep two CTAs an SM busy, else the narrowest
        busy = [t for t in fits if h * (w // t) >= 2 * SMS]
        assert p.tile == (busy[0] if busy else fits[-1])
        assert p.per_row * p.tile >= w and (p.per_row - 1) * p.tile < w
        # runs of one 16- (or 8-) byte store cover D exactly
        assert p.run_bytes == (16 if D * size % 16 == 0 else 8)
        assert p.run * size == p.run_bytes and D % p.run == 0
        # every staged span starts at a multiple of 4 columns and holds its pixels' windows
        m = p.margin
        assert m == max(window[1] // 2, 1)
        assert (-m - p.lead_left) % 4 == 0 and (-(D - 1) - m - p.lead_right) % 4 == 0
        assert p.left_cols % 4 == 0 and p.left_cols >= p.lead_left + p.tile + 2 * m
        assert p.right_cols % 4 == 0 and p.right_cols >= p.lead_right + p.tile + D - 1 + 2 * m
        assert p.left_cols - (p.lead_left + p.tile + 2 * m) < 4
        assert p.n_px == 2 * p.tile + D - 1
        # a warp writes out whole chunks: a power of two up to 128 bytes of a
        # pixel's row (16-byte runs), or the whole row of odd 8-byte runs
        chunk = p.chunk_runs * p.run_bytes
        assert D * size % chunk == 0 and chunk <= cost_cuda.CHUNK_MAX
        if p.run_bytes == 16:
            assert p.chunk_runs in (1, 2, 4, 8)
            assert chunk == cost_cuda.CHUNK_MAX or D * size % (2 * chunk)
        else:
            assert p.chunk_runs % 2 == 1 and chunk == (D * size if D * size <= 128 else 8)
        # the regions: the staged rows, later the warps' out buffers (16-byte
        # aligned), the codes (8-byte words), the BT triples
        stage = window[0] * (p.left_cols + p.right_cols) * 4
        assert p.codes_offset == max(stage, p.tile * chunk) and p.codes_offset % 16 == 0
        assert p.bt_offset == p.codes_offset + _words(window) * p.n_px * 8
        assert p.smem_bytes == p.bt_offset + 12 * p.n_px


def test_generic_form_exactly_where_no_tile_fits():
    assert _tile_plan(540, 768, 47, (7, 9), 1) is None  # 47 bytes a pixel
    assert _tile_plan(540, 768, 6, (7, 9), 2) is None  # 12 bytes
    assert _tile_plan(540, 768, 3, (7, 9), 4) is None  # 12 bytes
    assert _tile_plan(540, 768, 24, (7, 9), 1).run_bytes == 8
    assert _tile_plan(540, 768, 20000, (7, 9), 4) is None  # no stage fits shared memory


# the main paths' cost volumes: (h, w, D, window, size) -> (C, V, run bytes, K, smem bytes)
MAIN_PATHS = {
    "two_view_bench_int8": ((540, 768, 64, (7, 9), 1), (256, 16, 16, 4, 28076)),
    "two_view_bench_int16": ((540, 768, 64, (7, 9), 2), (256, 8, 16, 8, 44268)),
    "two_view_bench_float32": ((540, 768, 64, (7, 9), 4), (256, 4, 16, 8, 44268)),
    "two_view_entry_int16": ((256, 384, 64, (7, 9), 2), (128, 8, 16, 8, 22764)),
    "golden_fixture": ((540, 720, 64, (7, 9), 2), (256, 8, 16, 8, 44268)),
    "flat_d256": ((540, 768, 256, (7, 9), 1), (256, 16, 16, 8, 48108)),
    "cascade_coarse": ((135, 192, 64, (5, 7), 1), (64, 16, 16, 4, 7980)),
    "cascade_fine": ((540, 768, 24, (7, 9), 1), (256, 8, 8, 3, 26156)),
}


@pytest.mark.parametrize("path", sorted(MAIN_PATHS))
def test_tile_plan_at_the_main_paths(path):
    args, want = MAIN_PATHS[path]
    p = _tile_plan(*args)
    assert p is not None and (p.tile, p.run, p.run_bytes, p.chunk_runs, p.smem_bytes) == want
    assert p.per_row == -(-args[1] // p.tile)


def test_chip_smoke_rows_are_tiled_but_for_the_generic_one():
    """chip_smoke.py's K1 rows: every path's is tiled, the last is the
    generic form's."""
    for row, (h, w, D), window, dtype in chip_smoke.K1_ROWS:
        p = _tile_plan(h, w, D, window, SIZES[dtype])
        assert (p is None) == row.startswith("generic"), row


def _launch_args(monkeypatch, left, right, D, window, bt_weight, dtype):
    """What the wrapper hands ``svt_cost_volume`` for CPU images, the CUDA
    route, check and launch stood in for."""
    seen = []
    monkeypatch.setattr(cost_cuda, "resolve_backend", lambda t, b: "cuda")
    monkeypatch.setattr(_native, "check", lambda *a: None)
    monkeypatch.setattr(_native, "launch", lambda name, device, *a: seen.append((name, a)))
    # the launch count, restored after the test
    monkeypatch.setattr(fused_cost_volume_cuda, "launches", fused_cost_volume_cuda.launches)
    out = fused_cost_volume_cuda(left, right, D, window, bt_weight, 32.0, dtype)
    (name, args), = seen
    assert name == "svt_cost_volume" and args[2] == out.data_ptr()
    return args


@pytest.mark.parametrize("h,w,D,window,dtype", [
    (540, 768, 64, (7, 9), "int8"), (256, 384, 64, (7, 9), "int16"),
    (8, 100, 48, (5, 7), "float32"), (8, 100, 47, (7, 9), "int8"),
])
def test_wrapper_launches_with_the_plan(monkeypatch, h, w, D, window, dtype):
    left = torch.zeros((h, w))
    args = _launch_args(monkeypatch, left, left, D, window, 0.25, dtype)
    p = _tile_plan(h, w, D, window, SIZES[dtype])
    assert args[3:9] == (SIZES[dtype], h, w, D, *window)
    assert args[12] == cost_scale_for(dtype) and args[13] == (p.tile if p else 0)


def _popcount(a):
    return np.bitwise_count(a).astype(np.int32)


def _walk(left, right, D, window, bt_weight, dtype, plan):
    """The tiled kernel's schedule over (H, W) float32 numpy images: the
    (H, W, D) volume it stores."""
    h, w = left.shape
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    nw = _words(window)
    C, m, V = plan.tile, plan.margin, plan.run
    sw = plan.left_cols + plan.right_cols
    use_bt = bt_weight > 0.0
    bw, clip = F32(bt_weight), F32(32.0)
    if dtype == "float32":  # the wrapper's float32 worst
        worst = F32(wh * ww - 1) + (bw * clip if use_bt else F32(0))
    else:
        worst = F32(worst_cost(window, bt_weight, 32.0))
    scale = F32(cost_scale_for(dtype))
    out = np.empty((h, w, D), dtype)
    stale = np.random.default_rng(11)
    for y in range(h):
        for c in range(plan.per_row):
            x0 = c * C
            smem = stale.integers(0, 256, plan.smem_bytes, dtype=np.uint8)
            stage = smem[:wh * sw * 4].view(F32).reshape(wh, sw)
            codes = smem[plan.codes_offset:plan.bt_offset].view(np.uint64).reshape(nw, plan.n_px)
            bt = smem[plan.bt_offset:].view(F32).reshape(3, plan.n_px)
            # 1. stage, edge-clamped
            xs_l = x0 - m - plan.lead_left
            xs_r = x0 - (D - 1) - m - plan.lead_right
            assert xs_l % 4 == 0 and xs_r % 4 == 0
            for r in range(wh):
                yy = min(max(y + r - ph, 0), h - 1)
                stage[r, :plan.left_cols] = left[yy, np.clip(xs_l + np.arange(plan.left_cols),
                                                             0, w - 1)]
                stage[r, plan.left_cols:] = right[yy, np.clip(xs_r + np.arange(plan.right_cols),
                                                              0, w - 1)]
            # 2. one code and BT triple a pixel in the image
            i = np.arange(plan.n_px)
            is_left = i < C
            x = np.where(is_left, x0 + i, x0 - (D - 1) + (i - C))
            col = x - np.where(is_left, xs_l, xs_r) + np.where(is_left, 0, plan.left_cols)
            inside = (x >= 0) & (x < w)
            i, x, col, is_left = i[inside], x[inside], col[inside], is_left[inside]
            centre = stage[ph, col]
            words = np.zeros((nw, i.size), np.uint64)
            bit = 0
            for dy in range(wh):
                for dx in range(ww):
                    if dy == ph and dx == pw:
                        continue
                    less = stage[dy, col - pw + dx] < centre
                    words[bit >> 6] |= less.astype(np.uint64) << np.uint64(bit & 63)
                    bit += 1
            codes[:, i] = words
            if use_bt:
                img = np.where(is_left[:, None], left[y][None, :], right[y][None, :])
                lnb = np.where(x == 0, img[:, w - 1], stage[ph, col - 1])  # the wrap
                rnb = np.where(x == w - 1, img[:, 0], stage[ph, col + 1])
                lh, rh = F32(0.5) * (centre + lnb), F32(0.5) * (centre + rnb)
                bt[0, i] = centre
                bt[1, i] = np.minimum(np.minimum(lh, rh), centre)
                bt[2, i] = np.maximum(np.maximum(lh, rh), centre)
            # 3. the sweep: thread xl, pixel x0 + xl, runs of V disparities, K
            # of them into its warp's out buffer (region 0), then written out
            xl = np.arange(C)  # lanes past the row's end compute on stale operands
            lw = codes[:, xl]
            lt, l_mn, l_mx = bt[0, xl], bt[1, xl], bt[2, xl]
            region0 = smem[:plan.codes_offset]
            K, rb = plan.chunk_runs, plan.run_bytes
            for c0 in range(0, D, K * V):
                for q in range(K):
                    d = c0 + q * V + np.arange(V)
                    j = C + xl[:, None] + D - 1 - d[None, :]
                    _assert_operands_conflict_free(plan, j)
                    ham = sum(_popcount(lw[k][:, None] ^ codes[k][j]) for k in range(nw))
                    cost = ham.astype(F32)
                    with np.errstate(invalid="ignore", over="ignore"):  # stale operands
                        if use_bt:
                            rs, r_mn, r_mx = bt[0][j], bt[1][j], bt[2][j]
                            d_lr = np.maximum(F32(0), np.maximum(lt[:, None] - r_mx,
                                                                 r_mn - lt[:, None]))
                            d_rl = np.maximum(F32(0), np.maximum(rs - l_mx[:, None],
                                                                 l_mn[:, None] - rs))
                            cost = cost + bw * np.minimum(np.minimum(d_lr, d_rl), clip)
                        cost = np.where((x0 + xl)[:, None] < d[None, :], worst, cost).astype(F32)
                        if dtype == "float32":
                            run = cost
                        else:  # round half to even, then the low 8 or 16 bits
                            run = np.rint(cost * scale).astype(np.int32).astype(dtype)
                    lane = xl % 32
                    at = (xl - lane) * K * rb + _slot(lane, q, K) * rb
                    _assert_vectors_conflict_free(at, rb)
                    region0[at[:, None] + np.arange(rb)] = run.view(np.uint8).reshape(C, rb)
                # the write-out: piece lane + 32 i of a warp is run q of pixel p
                lane = np.arange(32)
                p, q = lane // K, lane % K
                dp, dq = 32 // K, 32 % K
                for wx0 in range(x0, min(x0 + C, w), 32):
                    n_valid = min(32, w - wx0)
                    for i in range(K):
                        at = (wx0 - x0) * K * rb + _slot(p, q, K) * rb
                        _assert_vectors_conflict_free(at, rb)
                        keep = p < n_valid
                        pieces = region0[at[keep, None] + np.arange(rb)].view(dtype)
                        for pp, qq, piece in zip(p[keep], q[keep], pieces.reshape(-1, V)):
                            out[y, wx0 + pp, c0 + qq * V:c0 + (qq + 1) * V] = piece
                        p, q = p + dp, q + dq
                        p, q = np.where(q >= K, p + 1, p), np.where(q >= K, q - K, q)
                    p, q = lane // K, lane % K
    return out


def _slot(p, q, K):
    """csrc/cost_volume.cu::buffer_slot."""
    swizzle = ((p * K) >> 3) & (K - 1) if K & (K - 1) == 0 else 0
    return p * K + (q ^ swizzle)


def _assert_vectors_conflict_free(at, rb):
    """Vector accesses of `rb` bytes at byte offsets `at`, one a lane: each
    phase (128 bytes of lanes) on distinct banks."""
    lanes = 128 // rb
    for k in range(0, at.size - lanes + 1, lanes):
        words = (at[k:k + lanes, None] // 4 + np.arange(rb // 4)) % 32
        assert np.unique(words).size == 32


def _assert_operands_conflict_free(plan, j):
    """The warp's reads of one disparity step (lanes = 32 consecutive
    pixels): each half-warp's 64-bit code words and each warp's BT floats on
    distinct banks."""
    for lane0 in range(0, j.shape[0] - 31, 32):
        jj = j[lane0:lane0 + 32, 0]
        for half in (jj[:16], jj[16:]):
            word = (plan.codes_offset + 8 * half) // 4
            banks = np.concatenate([word % 32, (word + 1) % 32])
            assert np.unique(banks).size == 32
        assert np.unique((plan.bt_offset + 4 * jj) // 4 % 32).size == 32


def _pair(h, w, seed, integer):
    b = np.random.default_rng(seed).uniform(0, 255, (h, w + 9)).astype(F32)
    if integer:  # 8-bit frames: exact .5 ties in the rounded costs
        b = np.floor(b)
    return np.ascontiguousarray(b[:, :w]), np.ascontiguousarray(b[:, 9:])


def _held_to_plain(h, w, D, window, bt_weight, dtype, tile=None, integer=True, seed=0):
    left, right = _pair(h, w, seed + D + w, integer)
    plan = _tile_plan(h, w, D, window, SIZES[dtype])
    if tile is not None:
        plan = _layout(tile, D, window, SIZES[dtype], w)
    assert plan is not None
    want = fused_cost_volume(torch.from_numpy(left), torch.from_numpy(right), D, window,
                             bt_weight, 32.0, dtype)
    got = _walk(left, right, D, window, bt_weight, dtype, plan)
    assert torch.equal(torch.from_numpy(got), want)
    return plan


CASES = {
    "ragged_last_tile": (3, 150, 16, (7, 9), 0.25, None),  # tiles of 64, 64, 22
    "w_below_c": (3, 40, 16, (7, 9), 0.25, None),
    "w_below_c_256": (2, 40, 16, (7, 9), 0.25, 256),
    "d_above_w": (3, 20, 32, (7, 9), 0.25, None),
    "d_above_c": (2, 100, 80, (7, 9), 0.25, None),
    "four_words": (3, 50, 16, (15, 17), 0.25, None),
    "bt_weight_0": (3, 70, 16, (7, 9), 0.0, None),
    "window_5x7_tile_128": (3, 300, 32, (5, 7), 0.25, 128),
    "runtime_window_3x1": (4, 37, 16, (3, 1), 0.5, None),
    "eight_byte_runs": (3, 90, 24, (7, 9), 0.25, None),
}


@pytest.mark.parametrize("dtype", sorted(SIZES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_walk_is_the_plain_twin(case, dtype):
    h, w, D, window, bt_weight, tile = CASES[case]
    if dtype == "int8" and window == (15, 17):
        pytest.raises(ValueError, fused_cost_volume, torch.zeros(2, 2), torch.zeros(2, 2), D,
                      window, dtype="int8")  # 254 bits overflow int8: the wrapper refuses
        window = (9, 11)  # 98 bits: two words
    if case == "eight_byte_runs" and dtype != "int8":
        D = 28 if dtype == "int16" else 22  # 56 and 88 bytes: 8-byte runs too
    plan = _held_to_plain(h, w, D, window, bt_weight, dtype, tile,
                          integer=dtype != "float32")
    assert plan.run_bytes == (8 if case == "eight_byte_runs" else 16)


def test_walk_on_float_images_at_int16():
    _held_to_plain(3, 130, 40, (7, 9), 0.25, "int16", integer=False)


def test_walk_is_the_pallas_wdh_builder():
    """The walk against the reference's TPU kernel in interpret mode."""
    left, right = _pair(16, 80, 3, True)
    D = 32
    plan = _tile_plan(16, 80, D, (7, 9), 1)
    want = np.asarray(fused_cost_volume_pallas_wdh(
        jnp.asarray(left), jnp.asarray(right), D, census_window=(7, 9), bt_weight=0.25,
        block_rows=16, interpret=True, out_dtype="int8"))  # (W, D, H)
    got = _walk(left, right, D, (7, 9), 0.25, "int8", plan)
    np.testing.assert_array_equal(got, want.transpose(2, 0, 1))
