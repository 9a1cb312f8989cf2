"""``pipeline: "array"``: ``models.serving.stream_depth_maps`` (and
``array_depth_pipeline`` per set) on uint8 frame-sets (N, H, W) of a
translation-only grid rig; the reference's ``depth(images, rig, engine,
refine_dtype)`` checks it."""

from __future__ import annotations

import numpy as np

from benchmark import scenes
from benchmark.pipelines import Pipeline


class Kind(Pipeline):
    fetch = ("refined_depth", "valid")

    def load(self) -> None:
        super().load()
        from stereovisionarray_tpu_torch.geometry.camera import camera_array_from_numpy
        from stereovisionarray_tpu_torch.models import array_depth_pipeline

        self.rig = scenes.grid_rig(self.config["rig"])
        r = self.rig
        self.cams = camera_array_from_numpy(r["fx"], r["fy"], r["cx"], r["cy"], r["R"], r["t"],
                                            device=self.device)
        self._run = array_depth_pipeline

    def make_pool(self, seed, n):
        """One render of the scene on the device, its texture from the seed,
        and `n` sets of it under fresh sensor noise (sigma ``noise`` grey
        levels), as 8-bit frames in host memory."""
        torch = self.torch
        h, w = self.config["rig"]["resolution"]
        rng = np.random.default_rng(seed)
        base = scenes.render_rig(self.rig, h, w, int(rng.integers(1, 2**31 - 1)), self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(rng.integers(0, 2**62)))
        sigma = float(self.config["noise"])
        return [scenes.to_uint8(base + sigma * torch.randn(
            base.shape, generator=gen, dtype=base.dtype, device=self.device)).cpu().numpy()
            for _ in range(n)]

    def call(self, frame_dev):
        return self._run(frame_dev.to(self.torch.float32), self.cams, self.cfg)

    def stream(self, frames, depth):
        from stereovisionarray_tpu_torch.models.serving import stream_depth_maps

        for fr in stream_depth_maps(frames, self.cams, self.cfg, depth=depth,
                                    transfer_dtype=np.uint8, device=self.device):
            yield fr.output, None

    def maps(self, out):
        return {"depth": out.depth, "refined_depth": out.refined_depth, "valid": out.valid}

    def reference(self, frame, control=False):
        images = self.torch.from_numpy(frame).to(self.device)
        dtype = getattr(self.torch, self.config["control"]["refine_dtype"] if control
                        else "float32")
        return self.ref.depth(images, self.rig, self.engine, refine_dtype=dtype)
