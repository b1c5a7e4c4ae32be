"""Device ops: banded DP fills, traceback walk, column vote (+ host seeding)."""
