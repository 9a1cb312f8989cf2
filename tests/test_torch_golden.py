"""The port on the committed golden fixture (data/eval_scene, 540x720, D=64):
its loader reads the files exactly as the reference's does, its integer path
is bit-exact to the reference's pallas_interpret path, and its metrics equal
the reference's records."""

import json
import struct
import zlib
from pathlib import Path

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovisionarray_tpu.config import CostConfig, SGMConfig
from stereovisionarray_tpu.datasets.middlebury import load_middlebury_pair as ref_load
from stereovisionarray_tpu.evaluation import bad_pixel_ratio as ref_bad
from stereovisionarray_tpu.evaluation import end_point_error as ref_epe
from stereovisionarray_tpu.models.two_view import two_view_disparity as ref_two_view
from stereovisionarray_tpu_torch.datasets.io import read_png
from stereovisionarray_tpu_torch.datasets.middlebury import load_middlebury_pair
from stereovisionarray_tpu_torch.evaluation import bad_pixel_ratio, end_point_error
from stereovisionarray_tpu_torch.models import two_view_disparity

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "data" / "eval_scene"
# scripts/make_eval_fixture.py:136-140
SGM = SGMConfig(p1=8.0, p2=96.0, num_paths=8, adaptive_p2=True, uniqueness=0.95,
                lr_max_diff=1.5)
# the reference's pallas_interpret path on this fixture (CPU)
GOLDEN = {
    "int16": {"bad_2.0": 0.0073033, "epe": 0.2927659, "density": 0.9592620},
    "int8": {"bad_2.0": 0.0072615, "epe": 0.2922293, "density": 0.9592108},
}
# its float32 route (float cost -> sgm_aggregate_pallas_hdw ->
# extract_disparity_hdw), computed with JAX on the CPU at full size
# (test_float_golden_is_the_reference_route recomputes it); torch_records'
# FLOAT_GOLDEN
FLOAT_GOLDEN = {"bad_2.0": 0.007297772914171219, "epe": 0.2934589385986328,
                "density": 0.9592484831809998}


@pytest.fixture(scope="module")
def pair():
    return load_middlebury_pair(str(SCENE))


def _metrics(out, pair):
    gt = torch.from_numpy(pair.gt_disparity)
    x = torch.arange(gt.shape[1])[None, :]
    matchable = torch.from_numpy(pair.valid_gt) & (x >= torch.ceil(gt))
    em = matchable & out.valid
    return {
        "bad_2.0": bad_pixel_ratio(out.disparity, gt, 2.0, mask=em).item(),
        "epe": end_point_error(out.disparity, gt, mask=em).item(),
        "density": ((out.valid & matchable).float().mean() / matchable.float().mean()).item(),
    }


def test_loader_reads_fixture_like_reference(pair):
    want = ref_load(str(SCENE))
    for name in ("left", "right", "gt_disparity"):
        got_a, want_a = getattr(pair, name), getattr(want, name)
        assert got_a.dtype == want_a.dtype
        np.testing.assert_array_equal(got_a, want_a)
    assert pair.calib.keys() == want.calib.keys() and pair.ndisp == want.ndisp == 64
    np.testing.assert_array_equal(pair.calib["cam0"], want.calib["cam0"])


def _write_png(path, img, filters):
    """Minimal PNG encoder applying the given filter type to each scanline."""
    h = img.shape[0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw += bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_handles_every_filter(tmp_path, channels):
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    img = np.random.default_rng(channels).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "filters.png"
    _write_png(path, img, filters=(0, 1, 2, 3, 4))
    got = read_png(str(path))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, iio.imread(path))


def test_metrics_match_reference():
    r = np.random.default_rng(8)
    d = r.uniform(-1, 30, (20, 30)).astype(np.float32)
    gt = r.uniform(0, 30, (20, 30)).astype(np.float32)
    for mask in (None, r.uniform(size=(20, 30)) > 0.3, r.uniform(size=(1, 30)) > 0.5):
        tm = None if mask is None else torch.from_numpy(mask)
        jm = None if mask is None else jnp.asarray(mask)
        assert bad_pixel_ratio(torch.from_numpy(d), torch.from_numpy(gt), 1.0, tm).item() == \
            pytest.approx(float(ref_bad(jnp.asarray(d), jnp.asarray(gt), 1.0, jm)), abs=1e-7)
        assert end_point_error(torch.from_numpy(d), torch.from_numpy(gt), tm).item() == \
            pytest.approx(float(ref_epe(jnp.asarray(d), jnp.asarray(gt), jm)), abs=1e-6)


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_integer_path_bit_exact_on_fixture(pair, dtype):
    cc = CostConfig(num_disparities=pair.ndisp, census_window=(7, 9), dtype=dtype)
    want = ref_two_view(jnp.asarray(pair.left), jnp.asarray(pair.right), cc, SGM,
                        backend="pallas_interpret")
    got = two_view_disparity(torch.from_numpy(pair.left), torch.from_numpy(pair.right), cc, SGM)
    for name in ("disparity", "valid", "cost"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.confidence.numpy(), np.asarray(want.confidence), atol=1e-6)
    metrics = _metrics(got, pair)
    for name, value in GOLDEN[dtype].items():
        assert metrics[name] == pytest.approx(value, abs=1e-6), name


def test_float_path_reproduces_eval_record(pair):
    record = json.loads((REPO / "EVAL_r03.json").read_text())
    cc = CostConfig(num_disparities=pair.ndisp, census_window=(7, 9), dtype="float32")
    got = two_view_disparity(torch.from_numpy(pair.left), torch.from_numpy(pair.right), cc, SGM,
                             backend="xla")
    metrics = _metrics(got, pair)
    assert metrics["bad_2.0"] == pytest.approx(record["bad_2.0"], abs=2e-4)
    assert metrics["epe"] == pytest.approx(record["epe"], abs=1e-3)
    assert metrics["density"] == pytest.approx(record["density"], abs=5e-4)


def _float_run(pair):
    cc = CostConfig(num_disparities=pair.ndisp, census_window=(7, 9), dtype="float32")
    return cc, two_view_disparity(torch.from_numpy(pair.left), torch.from_numpy(pair.right), cc,
                                  SGM)


def test_float_path_meets_float_golden(pair):
    """The float route's plain twins (K1 float, K7, K6) on the full fixture."""
    _, got = _float_run(pair)
    metrics = _metrics(got, pair)
    for name, value in FLOAT_GOLDEN.items():
        assert metrics[name] == pytest.approx(value, abs=1e-6), name


@pytest.mark.slow
def test_float_golden_is_the_reference_route(pair):
    """Recompute FLOAT_GOLDEN with the reference's pallas_interpret float
    route at full size; the port is bit-exact to it."""
    cc, got = _float_run(pair)
    want = ref_two_view(jnp.asarray(pair.left), jnp.asarray(pair.right), cc, SGM,
                        backend="pallas_interpret")
    for name in ("disparity", "valid", "cost"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    gt = jnp.asarray(pair.gt_disparity)
    x = jnp.arange(gt.shape[1])[None, :]
    matchable = jnp.asarray(pair.valid_gt) & (x >= jnp.ceil(gt))
    em = matchable & want.valid
    ref = {
        "bad_2.0": float(ref_bad(want.disparity, gt, 2.0, em)),
        "epe": float(ref_epe(want.disparity, gt, em)),
        "density": float(jnp.mean((want.valid & matchable).astype(jnp.float32))
                         / jnp.mean(matchable.astype(jnp.float32))),
    }
    for name, value in FLOAT_GOLDEN.items():
        assert ref[name] == pytest.approx(value, abs=1e-9), name
