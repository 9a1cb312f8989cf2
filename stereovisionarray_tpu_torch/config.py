"""Configuration tree of the port: a copy of ``stereovisionarray_tpu/config.py``.

The same frozen dataclasses, defaults, ``noise_robust_preset`` and
``to_dict`` / ``from_dict`` / ``from_json`` / ``override``, kept here so that
the port imports nothing of the JAX package. A configuration of the JAX
package carries across as ``EngineConfig.from_dict(jax_cfg.to_dict())``.

The original C++ program has no config system: every parameter is a literal
in its ``main`` (folder "Renders2" at ``src/CameraStereoVision.cpp:13``,
f=0.05 / sensor=0.036 at ``:24-25``, grid spacing 0.05 / z=-0.75 at ``:37``,
kernelSize=20 at ``:44``, topology MID_LEFT at ``:42``, refine window 21 at
``:114``). Here all of that lives in one serializable dataclass tree.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class CameraArrayConfig:
    """Geometry of the capture rig (reference: 5x5 grid, 0.05 m spacing,
    origin (-0.1, -0.1), z = -0.75, f = 50 mm, 36 mm sensor across the image,
    the original C++ program's ``src/CameraStereoVision.cpp:24-39``)."""

    rows: int = 5
    cols: int = 5
    spacing: float = 0.05
    origin: Tuple[float, float] = (-0.1, -0.1)
    z: float = -0.75
    focal_length: float = 0.05
    sensor_width: float = 0.036
    resolution: Tuple[int, int] = (540, 720)  # (H, W)

    @property
    def pixel_size(self) -> float:
        return self.sensor_width / self.resolution[1]


@dataclass(frozen=True)
class CostConfig:
    """Matching-cost construction (replaces the reference's 41x41 SAD,
    the original C++ program's ``src/CameraStereoVision.cpp:44,57``)."""

    census_window: Tuple[int, int] = (7, 9)  # (height, width), <= 64 bits
    num_disparities: int = 128
    bt_weight: float = 0.25  # Birchfield-Tomasi term weight vs census hamming
    bt_clip: float = 32.0
    # int16 = fixed-point costs (scale 4): exact integer SGM sums, HALF the
    # HBM traffic — 2.3x measured on the TPU Pallas path; the XLA path
    # falls back to float32 automatically (models/two_view.py)
    dtype: str = "int16"


@dataclass(frozen=True)
class SGMConfig:
    """Semi-global aggregation (the reference has only winner-take-all;
    SGM generalizes its local refinement into global smoothness)."""

    p1: float = 8.0
    p2: float = 96.0
    num_paths: int = 8  # 4 (H/V) or 8 (+diagonals)
    adaptive_p2: bool = True  # scale P2 down across intensity edges
    p2_min: float = 24.0
    lr_max_diff: float = 1.25  # left-right consistency threshold (px)
    subpixel: bool = True  # parabola refinement
    uniqueness: float = 0.95  # best/second-best ratio test (<=0 disables)
    median_filter: bool = False  # 3x3 median post-filter (ops/postfilter.py)
    speckle_window: int = 0  # speckle-suppression window (0 disables)
    speckle_max_diff: float = 1.0
    speckle_min_support: int = 12
    fill_holes: bool = False  # background-fill occlusion gaps (Hirschmueller)


def noise_robust_preset():
    """(CostConfig, SGMConfig) tuned for NOISY/defocused 8-bit captures,
    the reference's real-photo operating regime
    (the original C++ program's ``src/CameraStereoVision.cpp:14-19``), where the
    clean-data defaults collapse (EVAL_ROBUST_r03: bad-2.0 63% at severity
    3). A wider census window averages ordering evidence over more pixels,
    doubled P1/P2 smooths over noise-flipped bits, and relaxed
    uniqueness/LR gates stop rejecting pixels whose evidence is merely
    noisy. Measured on the perturbed golden fixture (severity 3: per-view
    gain/bias + read/shot noise + defocus): bad-2.0 63% -> 29% at 2x the
    density; clean-data cost is 0.73% -> 1.2% bad-2.0. Raising bt_weight
    instead HURTS under per-view gain/bias (BT compares raw intensities;
    census ordering ignores them). int8 volumes auto-widen to int16 for
    this window (142 census bits overflow int8)."""
    return (
        CostConfig(census_window=(11, 13)),
        SGMConfig(p1=16.0, p2=288.0, p2_min=72.0, adaptive_p2=True,
                  uniqueness=0.97, lr_max_diff=2.5),
    )


@dataclass(frozen=True)
class PlaneSweepConfig:
    """N-view plane-sweep fusion over the camera array."""

    num_planes: int = 128
    z_near: float = 0.55
    z_far: float = 1.1
    topology: str = "to_center"  # PairTopology value
    # caller asserts integer-valued [0, 255] sources (decoded 8-bit
    # frames): the Pallas sweep's bf16 warp is then EXACT with a single
    # matmul arm — half its MXU work. False (default) keeps the hi/lo
    # split, exact for any <= 16-significant-bit data.
    sources_8bit: bool = False
    fusion: str = "topk_mean"  # 'mean' | 'topk_mean' | 'min'
    topk: int = 6
    cost: str = "census"  # 'census' | 'sad' | 'zncc'
    patch: int = 5  # local window for sad/zncc
    # planes vmapped together per lax.map step: bounds the warp-stack
    # intermediate at (plane_chunk, S, H, W) while amortizing per-kernel
    # dispatch (plane-at-a-time measured 50 ms/frame-set at 5x5x270x360x128
    # on a v5e; chunked is several times faster)
    plane_chunk: int = 32
    # coarse-to-fine cascade (models/cascade_sweep.py): coarse pass at
    # 1/cascade_coarse_factor resolution positions a per-pixel
    # cascade_fine_planes-wide plane window (starts quantized to
    # cascade_band_step planes); translation-only rigs only. The fine
    # window must be wide enough to absorb coarse error + per-view band
    # misalignment — below ~num_planes/3 the band-boundary error rate
    # climbs steeply (tests/test_cascade_sweep.py). factor 4 both times
    # FASTER and scores better bad-2 than factor 2 at the bench config
    # (the speckle filter catches the coarser pass's blunders;
    # probe_cascade_stages2.py)
    cascade: bool = False
    cascade_coarse_factor: int = 4
    cascade_fine_planes: int = 48
    cascade_band_step: int = 8
    # "smooth" (r5 default: seam-free continuous pre-warp) or "band"
    # (r4 integer bands — comparison/fallback)
    cascade_mode: str = "smooth"


@dataclass(frozen=True)
class RefineConfig:
    """Multi-view photoconsistency refinement (generalizes the reference's
    ``improveWithDisparity`` ±5-step local search with 21x21 windows,
    the original C++ program's ``src/functions.cpp:11-52``)."""

    radius: int = 5
    step: float = 1.0
    window: int = 21
    subpixel: bool = True
    iterations: int = 1


@dataclass(frozen=True)
class SfMConfig:
    """Feature matching + bundle adjustment (replaces hard-coded poses)."""

    max_features: int = 512
    harris_k: float = 0.05
    nms_radius: int = 4
    descriptor_patch: int = 8
    match_ratio: float = 0.9
    ba_iterations: int = 20
    ba_damping: float = 1e-3
    huber_delta: float = 2.0
    pose_graph_iterations: int = 10


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. Axes: data (frames/pairs), disp (disparity axis of
    the cost volume), tile (image rows). Sizes of 1 disable an axis."""

    data: int = 1
    disp: int = 1
    tile: int = 1


@dataclass(frozen=True)
class EngineConfig:
    camera: CameraArrayConfig = field(default_factory=CameraArrayConfig)
    cost: CostConfig = field(default_factory=CostConfig)
    sgm: SGMConfig = field(default_factory=SGMConfig)
    plane_sweep: PlaneSweepConfig = field(default_factory=PlaneSweepConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    sfm: SfMConfig = field(default_factory=SfMConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0

    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {k!r} for {tp.__name__}")
                    ftype = fields[k].type
                    ftype = _resolve(ftype)
                    if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
                        kwargs[k] = build(ftype, v)
                    elif isinstance(v, list):
                        kwargs[k] = tuple(v)
                    else:
                        kwargs[k] = v
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "EngineConfig":
        return cls.from_dict(json.loads(s))

    def override(self, **dotted: Any) -> "EngineConfig":
        """Functional override by dotted path, e.g.
        ``cfg.override(**{"sgm.p1": 10, "cost.num_disparities": 64})``."""
        d = self.to_dict()
        for key, val in dotted.items():
            parts = key.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config path {key!r}")
            node[parts[-1]] = val
        return EngineConfig.from_dict(d)


_TYPES = {
    "CameraArrayConfig": CameraArrayConfig,
    "CostConfig": CostConfig,
    "SGMConfig": SGMConfig,
    "PlaneSweepConfig": PlaneSweepConfig,
    "RefineConfig": RefineConfig,
    "SfMConfig": SfMConfig,
    "MeshConfig": MeshConfig,
    "EngineConfig": EngineConfig,
}


def _resolve(tp):
    if isinstance(tp, str):
        return _TYPES.get(tp, tp)
    return tp
