"""Run one cell of the benchmark once, on the CUDA device(s) of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic mixes
and metrics are named in ``BENCHMARK.json``; ``pbcore/`` beside this file is
the harness. The last line of standard output is the result, as one JSON
object; the numbers of the correctness check are also the last lines of
standard error. Exits nonzero with no result without enough CUDA devices,
without the program (``hpclinalg_torch``) in the checkout, or when a module
of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache inside the checkout, at fixed paths: the
# program's own nvcc and g++ builds go to <root>/build by the program itself
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

if __name__ == "__main__":
    from pbcore.main import main

    sys.exit(main(sys.argv[1:], T0))
