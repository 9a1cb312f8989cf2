"""The port's build of the C++ codec (datasets/native_loader.py) and its
image I/O (datasets/io.py): the same arrays as the JAX package's loader and
as the port's own PNG decoder, bit for bit, and a build that is safe under
concurrent processes and never writes to native/build/."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from stereovisionarray_tpu.datasets import native_loader as jax_nl
from stereovisionarray_tpu_torch.datasets import io
from stereovisionarray_tpu_torch.datasets import native_loader as nl

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "data" / "eval_scene"


@pytest.fixture
def jax_codec(monkeypatch):
    """The JAX package's loader. Its library is built into native/build/ when
    tests/test_native_loader.py is collected, where parallel workers race for
    it; a process without it binds the port's build of the same sources, so
    this file never builds into native/build/ itself."""
    if jax_nl._lib is None:
        monkeypatch.setattr(jax_nl, "_lib", nl._get_lib())
        monkeypatch.setattr(jax_nl, "_build_error", None)
    return jax_nl


def test_port_library_builds_outside_native_build():
    assert nl.native_available(), nl.native_build_error()
    lib = Path(nl._LIB_PATH).resolve()
    assert lib.is_file() and lib.parent == (REPO / "stereovisionarray_tpu_torch" / "build")
    assert REPO / "native" not in lib.parents


@pytest.mark.parametrize("half_res", [False, True])
def test_eval_scene_decodes_as_the_reference_loader(jax_codec, half_res):
    paths = [str(SCENE / "im0.png"), str(SCENE / "im1.png")]
    got = io.load_image_stack(paths, half_res=half_res)
    assert got.dtype == np.float32 and got.shape[0] == 2
    assert np.array_equal(got, jax_codec.load_stack(paths, half_res=half_res))
    for k, p in enumerate(paths):
        assert np.array_equal(got[k], jax_codec.decode_image(p, half_res=half_res))
        assert np.array_equal(got[k], nl.decode_image(p, half_res=half_res))
        rgb = io.read_png(p)  # the port's own decoder, gray as the codec computes it
        want = io._gray(rgb)
        assert np.array_equal(got[k], want[:want.shape[0] // 2 * 2:2, :want.shape[1] // 2 * 2:2]
                              if half_res else want)
    rgb = nl.decode_image(paths[0], gray=False)
    assert np.array_equal(rgb, io.read_png(paths[0]).astype(np.float32))


@pytest.mark.parametrize("shape", [(33, 47), (21, 19, 3), (20, 30, 3), (9, 11, 4)])
@pytest.mark.parametrize("half_res", [False, True])
def test_fresh_pngs_decode_the_same_on_every_route(jax_codec, tmp_path, monkeypatch, shape,
                                                   half_res):
    """write_png's files through the C++ codec (the port's build and the
    reference's binding), and through read_png with the codec switched off."""
    a = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "x.png")
    io.write_png(p, a)
    assert np.array_equal(io.read_png(p), a)
    got = io.load_image_gray(p, half_res=half_res)
    assert np.array_equal(got, jax_codec.decode_image(p, half_res=half_res))
    h, w = shape[:2]
    assert got.shape == ((h // 2, w // 2) if half_res else (h, w))
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_build_error", "switched off")
    assert not io.native_available()
    assert np.array_equal(io.load_image_gray(p, half_res=half_res), got)
    assert np.array_equal(io.load_image_stack([p, p], half_res=half_res), np.stack([got, got]))


def test_save_png_on_both_encoders(tmp_path, monkeypatch):
    a = np.random.default_rng(3).uniform(-5, 260, (24, 31)).astype(np.float32)
    io.save_png(str(tmp_path / "n.png"), a, vmin=0.0, vmax=255.0)  # the C++ encoder
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "_build_error", "switched off")
    io.save_png(str(tmp_path / "p.png"), a, vmin=0.0, vmax=255.0)  # write_png
    want = np.clip(a, 0, 255).astype(np.uint8)
    assert np.array_equal(io.read_png(str(tmp_path / "n.png")), want)
    assert np.array_equal(io.read_png(str(tmp_path / "p.png")), want)
    with pytest.raises(ValueError, match="PNG"):
        io.save_png(str(tmp_path / "x.jpg"), a)


def test_prefetch_loader_keeps_order(tmp_path):
    paths = []
    for i in range(7):
        p = str(tmp_path / f"f{i}.png")
        io.write_png(p, np.full((6, 5), 30 * i, np.uint8))
        paths.append(p)
    with nl.PrefetchLoader(paths, threads=3, capacity=2) as ld:
        frames = list(ld)
    assert [float(f[0, 0]) for f in frames] == [30.0 * i for i in range(7)]
    assert io.list_images_sorted(str(tmp_path)) == sorted(paths)


def test_concurrent_builds_are_safe(tmp_path):
    """Six processes build into one empty directory at once: all load a
    whole library (one compiles under the lock, the rest wait for it), no
    temporary file is left, and native/build/ is not touched."""
    native_build = REPO / "native" / "build"
    before = sorted((f.name, f.stat().st_mtime_ns) for f in native_build.iterdir()) \
        if native_build.is_dir() else None
    code = textwrap.dedent(f"""
        import os
        from stereovisionarray_tpu_torch.datasets import native_loader as nl
        nl._BUILD_DIR = {str(tmp_path)!r}
        nl._LIB_PATH = os.path.join(nl._BUILD_DIR, "libsvt_io.so")
        assert nl.native_available(), nl.native_build_error()
        assert nl.decode_image({str(SCENE / "im0.png")!r}).shape == (540, 720)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(os.listdir(tmp_path)) == ["libsvt_io.lock", "libsvt_io.so"]
    after = sorted((f.name, f.stat().st_mtime_ns) for f in native_build.iterdir()) \
        if native_build.is_dir() else None
    assert after == before
