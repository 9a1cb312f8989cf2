"""Sizes of the configurations registered after ``helpers.SMALL`` and
``helpers.ON_CARD`` were written: ``tiny_bench`` sizes every configuration
``BENCHMARK.json`` lists, so each needs an entry before a test builds one."""

from benchmark.tests import helpers

# 24 sources and top-6 kept; the frame and the planes cut as for the CROSS rig
helpers.SMALL.setdefault("array5x5_tocenter", {
    "rig.resolution": [27, 36], "engine.camera.resolution": [27, 36],
    "engine.plane_sweep.num_planes": 12})
helpers.ON_CARD.setdefault("array5x5_tocenter", {})
