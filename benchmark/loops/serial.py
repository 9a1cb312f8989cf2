"""``loop: "serial"``: one closed-loop client. Each unit is copied from
pinned host memory to the card, run, and the pipeline's ``fetch`` maps are
copied back into pinned host memory before the next unit is handed over;
its latency runs from handover to maps on the host."""

from __future__ import annotations

import time

import numpy as np

from benchmark import loops


class Loop(loops.Loop):
    def __init__(self, torch, pipe, pool, traffic, seed):
        super().__init__(torch, pipe, pool, traffic, seed)
        pin = pipe.device.type == "cuda"
        self.pinned = [torch.from_numpy(f) for f in pool]
        if pin:
            self.pinned = [f.pin_memory() for f in self.pinned]
        probe = pipe.maps(pipe.call(pipe.to_device(self.pinned[0])))
        pipe.synchronize()

        def bufs():
            return {k: torch.empty(probe[k].shape, dtype=probe[k].dtype, pin_memory=pin)
                    for k in pipe.fetch}

        self.scratch = bufs()
        self.slot_bufs = [bufs() for _ in range(self.k)]

    def window(self, seconds, slots, spans):
        pipe, pinned, P, n_max = self.pipe, self.pinned, len(self.pool), len(slots)
        lat = np.zeros(n_max, dtype=np.float64)
        samples = [None] * self.k
        t_first = time.perf_counter()
        t_end = t_first + seconds
        n = 0
        while n < n_max:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            s = slots[n]
            with spans("bench.call"):
                out = pipe.call(pipe.to_device(pinned[n % P]))
            bufs = self.slot_bufs[s] if s >= 0 else self.scratch
            with spans("bench.fetch"):
                for key, buf in bufs.items():
                    buf.copy_(getattr(out, key), non_blocking=True)
            with spans("bench.wait"):
                pipe.synchronize()
            lat[n] = time.perf_counter() - t0
            if s >= 0:
                samples[s] = (n % P, out, bufs)
            n += 1
        return loops.Window(n, time.perf_counter() - t_first, lat[:n], samples)
