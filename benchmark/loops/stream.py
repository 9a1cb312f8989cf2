"""``loop: "stream"``: the units of the pool, in turn, handed to the
pipeline's streaming layer as fast as it takes them (``depth`` in flight);
with ``wait`` the consumer waits for each unit's own work, in order, as a
client that uses every result does."""

from __future__ import annotations

import time

from benchmark import loops


class Loop(loops.Loop):
    def window(self, seconds, slots, spans):
        pool, P, n_max = self.pool, len(self.pool), len(slots)
        wait = bool(self.traffic.get("wait", False))
        samples = [None] * self.k
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def frames():
            i = 0
            while i < n_max and time.perf_counter() < t_end:
                yield pool[i % P]
                i += 1

        n = 0
        for out, done in self.pipe.stream(frames(), int(self.traffic["depth"])):
            if wait and done is not None:
                with spans("bench.wait"):
                    done.synchronize()
            s = slots[n]
            if s >= 0:
                samples[s] = (n % P, out, None)
            n += 1
        self.pipe.synchronize()
        return loops.Window(n, time.perf_counter() - t0, None, samples)
