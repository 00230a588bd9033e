"""Run one cell of BENCHMARK.json and print its result line.

    python3 vtbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exit codes: 0 with a result line (``correct`` may be false); 2 when the
checkout has no BENCHMARK.json or no such cell; 3 when the cards the cell
asks for are not there; 4 when jax, jaxlib, flax or the JAX package is
loaded once the window has closed. No result is printed on 2, 3 or 4.

The caches of the program (the kernels' nvcc builds under
``videotransformer_tpu_torch/build/``, Triton's, torch's extensions, the
exported serving programs) stay in fixed directories inside the checkout,
set here before torch is imported.
"""

import os
import sys
import time

_STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "vtbench", ".cache")


def process_age_s():
    """Seconds since this process started (``/proc/self/stat``), or since
    this module was loaded where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _STARTED


def set_environment():
    """Fixed cache directories inside the checkout, and no JAX from any
    library that would load it by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root=ROOT):
    args = parse_args(argv)
    set_environment()
    started = time.perf_counter() - process_age_s()
    from vtbench import harness

    return harness.main(args, root, started)


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT  # import vtbench as a package, never by file
    sys.exit(main())
