"""K8's specialised kernel (``plane_sweep_fast_kernel`` in
``csrc/plane_sweep.cu``), walked in numpy on the CPU.

The kernel gives each warp a strip of 64 columns by 6 rows (4 at patch 7;
each lane two neighbouring columns) and each block 8 planes (4 from 16
sources up), takes the columns beside a lane's from its neighbours
by shuffles (a lane past the warp's edge reads its own value back), builds
each census bit as the sign bit of the float difference nb - centre over
values normalised by adding +0, shifts it into 32-bit words, keeps each
view's cost as its popcount with a lane's two pixels packed as 16-bit
halves, merges an out-of-view source's ceiling with a mask, fuses by one
packed add (the means) or by an insertion network of unsigned 16x2 minima
and maxima over NK ascending slots (top-k, k rounded up to even), and
converts to float once at the write-out. The walk below does the same, lane
by lane, with the kernel's indexing and float32 arithmetic, and is held bit
for bit to the plain twin ``plane_sweep_census_plain`` over every fusion,
patch 3, 5 and 7, top-k 1 to 8, shapes that cut strips and blocks, and
images of -0.0, exact ties, negative values, infinities and NaN. A float
difference the card computes as NaN is its positive canonical NaN; the
walk gives it that sign."""

import numpy as np
import pytest
import torch

from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census_plain

F32 = np.float32
U32 = np.uint32
WARPS = 4  # warps a block


def _rows(patch):
    """Output rows a lane owns."""
    return 4 if patch == 7 else 6


def _planes(n_src):
    """Planes a block."""
    return 4 if n_src >= 16 else 8


def _sign_bits(d):
    """Sign bit of a float32 difference as the card leaves it (NaN: +)."""
    bits = d.astype(F32).view(U32)
    return np.where(np.isnan(d), U32(0), bits >> U32(31))


def _lane_at(v, dl):
    """v of lane (lane + dl) along the last axis; lanes past the warp keep their own."""
    if dl == 0:
        return v
    out = v.copy()
    if dl > 0:
        out[..., :-dl] = v[..., dl:]
    else:
        out[..., -dl:] = v[..., :dl]
    return out


def _census(v, patch, normalise=True):
    """Census words [r][c][k] of each lane's rows x 2 pixels from its two
    columns' values v[c][i] (rows y0 - M + i), bits shifted in in
    census order."""
    M = patch // 2
    ROWS = _rows(patch)
    n_words = (patch * patch + 30) // 32
    if normalise:
        v = [[x + F32(0.0) for x in col] for col in v]
    bits = [[[np.zeros(v[0][0].shape, U32) for _ in range(n_words)] for _ in range(2)]
            for _ in range(ROWS)]
    for i in range(ROWS + 2 * M):
        row = []
        for j in range(2 + 2 * M):
            col = j - M
            dl = col // 2
            row.append(_lane_at(v[col - 2 * dl][i], dl))
        for r in range(ROWS):
            dy = i - M - r
            if not -M <= dy <= M:
                continue
            for c in range(2):
                centre = v[c][r + M]
                for dx in range(-M, M + 1):
                    if (dy, dx) == (0, 0):
                        continue
                    k = (dy + M) * patch + (dx + M) - (1 if (dy > 0 or (dy == 0 and dx > 0)) else 0)
                    word = bits[r][c][k // 32]
                    bits[r][c][k // 32] = (word << U32(1)) | _sign_bits(row[c + dx + M] - centre)
    return bits


def _min16(a, b):
    return np.minimum(a & U32(0xFFFF), b & U32(0xFFFF)) | (np.minimum(a >> U32(16), b >> U32(16)) << U32(16))


def _max16(a, b):
    return np.maximum(a & U32(0xFFFF), b & U32(0xFFFF)) | (np.maximum(a >> U32(16), b >> U32(16)) << U32(16))


def fast_walk(ref, src, shifts, patch, valid_mean=False, topk=None, normalise=True):
    """(fused (H, W, D) float32, nviews (H, W, D) int32) as the specialised
    kernel computes them; each output element is written exactly once."""
    S, h, w = src.shape
    D = shifts.shape[0]
    M = patch // 2
    ROWS, PLANES = _rows(patch), _planes(S)
    C = ROWS + 2 * M
    kout = 64 - 2 * M
    ceiling2 = U32((patch * patch - 1) * 0x00010001)
    mode = 2 if topk is not None else (1 if valid_mean else 0)
    nk = (topk + 1) & ~1 if mode == 2 else 0
    fill = ceiling2 if (nk > 0 or mode == 0) else U32(0)
    lane = np.arange(32)
    # every warp of a chunk of planes: (strip, row group) -> x0 (W, 32), y0 (W, 1)
    strips = -(-w // kout)
    groups = [g for g in range(-(-h // (WARPS * ROWS)) * WARPS) if g * ROWS < h]
    x0 = np.array([[bx * kout - M + 2 * ln for ln in lane] for g in groups for bx in range(strips)])
    y0 = np.array([[g * ROWS] for g in groups for bx in range(strips)])
    ref_v = [[ref[np.clip(y0 - M + i, 0, h - 1), np.clip(x0 + c, 0, w - 1)] for i in range(C)]
             for c in range(2)]
    ref_bits = _census(ref_v, patch, normalise)
    fused = np.full((h, w, D), np.nan, F32)
    nviews = np.full((h, w, D), -1, np.int32)
    written = np.zeros((h, w, D), np.int32)
    u0, u1 = x0.astype(F32), (x0 + 1).astype(F32)
    v_lane = (y0 + lane).astype(F32)
    for d_first in range(0, D, PLANES):
        n_here = min(PLANES, D - d_first)
        num = np.zeros((n_here, ROWS) + x0.shape, U32)
        nvp = np.zeros((n_here, ROWS) + x0.shape, U32)
        for dd in range(n_here):
            d = d_first + dd
            acc = [np.zeros(x0.shape, U32) for _ in range(ROWS)]
            nv = [np.zeros(x0.shape, U32) for _ in range(ROWS)]
            slot = [[np.full(x0.shape, 0xFFFFFFFF, U32) for _ in range(max(nk, 1))]
                    for _ in range(ROWS)]
            # every source's warp and census at once: arrays (S, W, 32)
            su, sv = shifts[d, :, 0][:, None, None], shifts[d, :, 1][:, None, None]
            i0f, j0f = np.floor(su), np.floor(sv)
            fu, fv = su - i0f, sv - j0f
            gu, gv = F32(1.0) - fu, F32(1.0) - fv
            xs = x0 + i0f.astype(np.int64)
            ys = y0 - M + j0f.astype(np.int64)
            s_idx = np.arange(S)[:, None, None]

            def load(yy, xx):
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                return np.where(ok, src[s_idx, np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], F32(0))

            ha = [load(ys + i, xs) * gu + load(ys + i, xs + 1) * fu for i in range(C + 1)]
            hb = [load(ys + i, xs + 1) * gu + load(ys + i, xs + 2) * fu for i in range(C + 1)]
            v = [[ha[i] * gv + ha[i + 1] * fv for i in range(C)],
                 [hb[i] * gv + hb[i + 1] * fv for i in range(C)]]
            all_bits = _census(v, patch, normalise)
            su2, sv2 = i0f + fu, j0f + fv
            all_ok0 = (u0 + su2 >= 0) & (u0 + su2 <= F32(w - 1))
            all_ok1 = (u1 + su2 >= 0) & (u1 + su2 <= F32(w - 1))
            all_rows_ok = (v_lane + sv2 >= 0) & (v_lane + sv2 <= F32(h - 1))  # lane r: row y0 + r
            for s in range(S):
                bits = [[[k[s] for k in c] for c in r] for r in all_bits]
                ok0, ok1, rows_ok = all_ok0[s], all_ok1[s], all_rows_ok[s]
                cols_in = np.where(ok0, U32(0xFFFF), U32(0)) | np.where(ok1, U32(0xFFFF0000), U32(0))
                for r in range(ROWS):
                    inside = np.where(rows_ok[:, r:r + 1], cols_in, U32(0))
                    cost = U32(0)
                    for c in range(2):
                        p = sum(np.bitwise_count(b ^ rb).astype(U32)
                                for b, rb in zip(bits[r][c], ref_bits[r][c]))
                        cost = cost | (p << U32(16 * c))
                    val = (cost & inside) | (fill & ~inside)
                    nv[r] = nv[r] + (inside & U32(0x00010001))
                    if nk:
                        for i in range(nk - 1, 0, -1):
                            slot[r][i] = _min16(slot[r][i], _max16(slot[r][i - 1], val))
                        slot[r][0] = _min16(slot[r][0], val)
                    else:
                        acc[r] = acc[r] + val
            for r in range(ROWS):
                total = acc[r]
                if nk:
                    total = slot[r][0]
                    for i in range(1, topk):
                        total = total + slot[r][i]
                num[dd, r] = total
                nvp[dd, r] = (nv[r] | (nv[r] >> U32(8))) & U32(0xFFFF)
        inv = F32(1.0) / F32(topk if nk else S)
        for r in range(ROWS):
            y = y0[:, 0] + r
            for c in range(2):
                x = x0 + c
                out_lane = (2 * lane + c >= M) & (2 * lane + c < 64 - M)
                keep = out_lane[None, :] & (x < w) & (y[:, None] < h)
                wi, li = np.nonzero(keep)
                for dd in range(n_here):
                    n = ((num[dd, r] >> U32(16 * c)) & U32(0xFFFF)).astype(F32)
                    cnt = ((nvp[dd, r] >> U32(8 * c)) & U32(0xFF)).astype(np.int32)
                    out = (n / np.maximum(cnt, 1).astype(F32)) if (nk == 0 and mode == 1) else n * inv
                    yy, xx = y[wi], x[wi, li]
                    fused[yy, xx, d_first + dd] = out[wi, li]
                    nviews[yy, xx, d_first + dd] = cnt[wi, li]
                    written[yy, xx, d_first + dd] += 1
    assert (written == 1).all(), "an output element written other than once"
    return fused, nviews


def _images(rng, values, S, h, w):
    if values == "uniform":
        pool = None
    elif values == "signed_zeros_and_ties":
        pool = np.array([-0.0, 0.0, 1.0, -1.0, 2.0], F32)
    elif values == "negative":
        pool = (-np.round(rng.uniform(0, 4, 16)) - 0.5 * (rng.uniform(size=16) < 0.3)).astype(F32)
    else:
        pool = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3.0, -3.0, 1e38, -1e38], F32)
    if pool is None:
        return rng.uniform(0, 255, (h, w)).astype(F32), rng.uniform(0, 255, (S, h, w)).astype(F32)
    return rng.choice(pool, (h, w)).astype(F32), rng.choice(pool, (S, h, w)).astype(F32)


def _shifts(rng, D, S, h, w, spread=9.0):
    sh = rng.uniform(-spread, spread, (D, S, 2)).astype(F32)
    sh[::2] = np.round(sh[::2])  # integer shifts: the warp copies the values, ties stay ties
    sh[-1, 0] = (w + 5.0, -h - 3.5)  # a source entirely out of view
    return sh


def _check(ref, src, sh, patch, valid_mean, topk, normalise=True):
    with np.errstate(invalid="ignore", over="ignore"):  # inf - inf, inf * 0: NaN by design
        got = fast_walk(ref, src, sh, patch, valid_mean, topk, normalise)
    want = plane_sweep_census_plain(torch.from_numpy(ref), torch.from_numpy(src),
                                    torch.from_numpy(sh), patch, valid_mean, topk)
    return all(np.array_equal(g.view(np.int32), wt.numpy().view(np.int32))
               for g, wt in zip(got, want))


FUSIONS = [(False, None), (True, None), (False, 1), (False, 2), (False, 5), (False, 8)]


@pytest.mark.parametrize("values", ["uniform", "signed_zeros_and_ties", "negative",
                                    "infinities_and_nan"])
@pytest.mark.parametrize("valid_mean,topk", FUSIONS)
@pytest.mark.parametrize("patch", [3, 5, 7])
def test_fast_walk_equals_plain_twin(patch, valid_mean, topk, values):
    rng = np.random.default_rng(patch * 100 + (topk or 0) + 50 * valid_mean)
    S, h, w, D = 9, 11, 23, 10
    ref, src = _images(rng, values, S, h, w)
    assert _check(ref, src, _shifts(rng, D, S, h, w), patch, valid_mean, topk)


@pytest.mark.parametrize("h,w", [(15, 59), (17, 61), (16, 60), (23, 63), (25, 57), (5, 121),
                                 (25, 3)])
@pytest.mark.parametrize("patch", [3, 5, 7])
def test_fast_walk_cut_strips_and_blocks(patch, h, w):
    """Shapes one either side of a strip (64 - 2M columns, twice that) and
    of the block's rows (24, 16 at patch 7), planes that do not fill the
    chunk of 8, and shifts wider than a strip."""
    rng = np.random.default_rng(h * w + patch)
    S, D = 4, 9
    ref, src = _images(rng, "uniform", S, h, w)
    assert _check(ref, src, _shifts(rng, D, S, h, w, spread=70.0), patch, False, 3)


@pytest.mark.parametrize("topk", [6, 7])
def test_fast_walk_24_sources(topk):
    """The to_center form: 24 sources, the 6 best (and 7: eight slots), in
    chunks of 4 planes, the last one cut."""
    rng = np.random.default_rng(topk)
    S, h, w, D = 24, 9, 20, 6
    ref, src = _images(rng, "uniform", S, h, w)
    assert _check(ref, src, _shifts(rng, D, S, h, w, spread=20.0), 5, False, topk)


def test_fast_walk_needs_the_normalisation():
    """Without the +0 the sign of (-0) - (+0) claims -0 < +0: the walk then
    differs from the plain twin on images of signed zeros, so the cases above
    hold the trap."""
    rng = np.random.default_rng(7)
    S, h, w, D = 4, 9, 17, 4
    ref, src = _images(rng, "signed_zeros_and_ties", S, h, w)
    sh = _shifts(rng, D, S, h, w)
    assert _check(ref, src, sh, 5, False, None)
    assert not _check(ref, src, sh, 5, False, None, normalise=False)
