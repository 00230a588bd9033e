"""vtbench: the benchmark of ``videotransformer_tpu_torch`` on NVIDIA H100s.

One command runs one cell of ``BENCHMARK.json`` (a model configuration
under a traffic mix) and prints one JSON line:

    python3 vtbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:

- ``vtbench/configs/<config>.json``: the sizes, the source and the flags;
- ``vtbench/traffic/<traffic>.json``: the parameters of a mix, read by its
  general driver (``drivers/serve.py`` or ``drivers/train.py``);
- ``vtbench/metrics/<metric>.py``: a reader with ``read(run)`` that
  returns the number, or None where it finds nothing to read.

The yardstick lives here too and nowhere in the program: the traffic
generators, the reduction of the profiler's trace and of the harness's
spans to metrics (``tracing.py``), the peaks and the frozen operation and
byte counts (``counts.py``), the plain references (``reference/``) and
the comparisons that decide ``correct`` (``compare.py``). Nothing here
imports the JAX package, jax or flax; ``run.py`` refuses to print a result
when any of them is loaded.
"""
