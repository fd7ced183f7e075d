"""repro_torch.serving — the CNN/MLP serving tier (DESIGN.md §10), port of
``repro.serving`` on one device.

A FIFO request queue continuously batched into padded bucket shapes
{1, 8, 32, 128}, one CUDA graph per bucket captured at startup::

    from repro_torch import serving
    eng = serving.ServeEngine(spec, params, serving.ServeEngineConfig())
    eng.submit(image)
    done = eng.run_tick()          # -> completed Requests with latencies
    print(eng.stats())             # requests/s, p50/p99 per bucket

The JAX package's ``serving/aot.py`` has no module here.  Where each of
its pieces went:

- AOT lower and compile: ``launch.graphs.capture`` per bucket at startup
  (``ServeEngine.warm``).
- The persistent compilation cache: the kernel library, which
  ``kernels/build.py`` builds once per source hash into the git-ignored
  ``build/repro_torch/<hash>/`` and loads on restart without ``nvcc``.
- Executable snapshots (``save_executable``, ``load_executable``,
  ``snapshot_key``): no counterpart; a CUDA graph holds one process's
  device addresses and cannot be written to disk.  So there is no
  ``cache_dir``.
"""
from repro_torch.serving.batcher import (DEFAULT_BUCKETS, ContinuousBatcher,
                                         Request, pad_bucket, smallest_bucket)
from repro_torch.serving.server import (ServeEngine, ServeEngineConfig,
                                        percentile)

__all__ = [
    "DEFAULT_BUCKETS", "ContinuousBatcher", "Request", "pad_bucket",
    "smallest_bucket",
    "ServeEngine", "ServeEngineConfig", "percentile",
]
