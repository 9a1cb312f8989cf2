"""``pipeline: "two_view"``: ``models.two_view_disparity`` on uint8
rectified pairs (2, H, W), streamed through ``parallel.streaming.StreamExecutor``;
the reference's ``disparity(left, right, engine)`` checks it."""

from __future__ import annotations

import numpy as np

from benchmark import scenes
from benchmark.pipelines import Pipeline


class Kind(Pipeline):
    fetch = ("disparity", "valid")

    def load(self) -> None:
        super().load()
        from stereovisionarray_tpu_torch.models import two_view_disparity

        self._run = two_view_disparity

    def make_pool(self, seed, n):
        h, w = self.config["image"]
        rng = np.random.default_rng(seed)
        return [scenes.to_uint8(np.stack(scenes.large_range_pair(rng, h, w))) for _ in range(n)]

    def call(self, frame_dev):
        return self._run(frame_dev[0], frame_dev[1], self.cfg.cost, self.cfg.sgm)

    def stream(self, frames, depth):
        from stereovisionarray_tpu_torch.parallel.streaming import StreamExecutor

        cuda = self.device.type == "cuda"

        def step(frame_dev):
            out = self.call(frame_dev)
            if not cuda:
                return out, None
            done = self.torch.cuda.Event()
            done.record()
            return out, done

        return StreamExecutor(step, depth=depth, device=self.device).run(frames)

    def maps(self, out):
        return {"disparity": out.disparity, "valid": out.valid, "cost": out.cost,
                "confidence": out.confidence}

    def reference(self, frame, control=False):
        pair = self.torch.from_numpy(frame).to(self.device)
        return self.ref.disparity(pair[0], pair[1], self.engine)
