"""The port's temporal filter (models/temporal.py) against the JAX package's
on the same numpy streams, on the CPU: bit-exact. The blend
``w_prev * d_state + c * d`` is one fused multiply-add in XLA's CPU compile;
the port rounds it once the same way (ops/sgm.fmaf)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_records
from stereovisionarray_tpu.models import temporal as jt
from stereovisionarray_tpu_torch.models import temporal as tt
from stereovisionarray_tpu_torch.ops.sgm import fma3, fmaf

FIELDS = ("disparity", "valid", "stability", "coasted")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs six workers
    on the machine's cores, and ops split over every core in each worker
    oversubscribe them (a pipeline call then ran a hundred times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, t=8, h=64, w=96):
    """A static surface with noise, a jump of 5 px over a third of the image
    from frame t/2 (motion), random holes, and PKRN-like confidences."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(5, 40, (h, w)).astype(np.float32)
    d = (base[None] + rng.normal(0, 0.6, (t, h, w))).astype(np.float32)
    d[t // 2:, :, : w // 3] += 5.0
    v = rng.uniform(size=(t, h, w)) > 0.2
    v[2:5, 10:30, 40:70] = False  # a hole longer than max_hole_age
    c = rng.uniform(0, 1, (t, h, w)).astype(np.float32)
    return d, v, c


def _assert_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert np.array_equal(a.numpy(), np.asarray(b)), f


@pytest.mark.parametrize("kw", [{}, dict(max_diff=1.5), dict(max_weight=4.0, max_hole_age=2),
                                dict(coast_min_weight=0.25)])
@pytest.mark.parametrize("with_conf", [True, False])
def test_filter_sequence_is_bit_exact(kw, with_conf):
    d, v, c = _stream(0)
    want = jt.temporal_filter_sequence(jnp.asarray(d), jnp.asarray(v),
                                       jnp.asarray(c) if with_conf else None, **kw)
    got = tt.temporal_filter_sequence(torch.from_numpy(d), torch.from_numpy(v),
                                      torch.from_numpy(c) if with_conf else None, **kw)
    _assert_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_update_steps_are_bit_exact(seed):
    """temporal_update step by step from temporal_init, each step's state
    equal too."""
    d, v, c = _stream(seed)
    sj = jt.temporal_init(d.shape[1:])
    st = tt.temporal_init(d.shape[1:])
    for k in range(d.shape[0]):
        sj, oj = jt.temporal_update(sj, jnp.asarray(d[k]), jnp.asarray(v[k]), jnp.asarray(c[k]),
                                    max_diff=1.5)
        st, ot = tt.temporal_update(st, torch.from_numpy(d[k]), torch.from_numpy(v[k]),
                                    torch.from_numpy(c[k]), max_diff=1.5)
        _assert_equal(ot, oj)
        for f in ("disparity", "weight", "age"):
            assert np.array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f))), (k, f)
        assert st.age.dtype == torch.int32


def test_resume_from_a_mid_stream_state():
    """A state carried across from the reference mid-stream (numpy) resumes
    to the same outputs as the reference."""
    d, v, c = _stream(3)
    sj = jt.temporal_init(d.shape[1:])
    for k in range(4):
        sj, _ = jt.temporal_update(sj, jnp.asarray(d[k]), jnp.asarray(v[k]), jnp.asarray(c[k]))
    st = tt.TemporalState(*(torch.from_numpy(np.array(a)) for a in sj))
    for k in range(4, 8):
        sj, oj = jt.temporal_update(sj, jnp.asarray(d[k]), jnp.asarray(v[k]), jnp.asarray(c[k]))
        st, ot = tt.temporal_update(st, torch.from_numpy(d[k]), torch.from_numpy(v[k]),
                                    torch.from_numpy(c[k]))
        _assert_equal(ot, oj)


def test_fmaf_rounds_once():
    """fmaf against numpy's float64 product and sum where that is exact, and
    fma3 as the special case it was."""
    rng = np.random.default_rng(4)
    a, b, c = (torch.from_numpy(rng.uniform(-8, 8, 4096).astype(np.float32)) for _ in range(3))
    got = fmaf(a, b, c)
    want = (a.double() * b.double() + c.double()).float()  # one rounding but for exact halves
    assert (got != want).sum() <= 1
    assert torch.equal(fma3(b, c), fmaf(3.0, b, c))


def test_perturb_views_copy_equals_the_script():
    spec = importlib.util.spec_from_file_location(
        "make_robust_eval", Path(__file__).resolve().parents[1] / "scripts" / "make_robust_eval.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    views = np.random.default_rng(5).uniform(0, 255, (2, 40, 56)).astype(np.float32)
    for level in (0, 1, 2):
        got = torch_records.perturb_views(views, level, np.random.default_rng(100 + level))
        want = script.perturb_views(views, level, np.random.default_rng(100 + level))
        assert np.array_equal(got, want), level
