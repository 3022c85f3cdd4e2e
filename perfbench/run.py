"""Run one cell of BENCHMARK.json once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Every build and kernel cache stays inside the checkout. Exits with another
code than 0, and prints no result, without a card, without the program, or
with JAX, Flax or the JAX package loaded once the window has closed."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)
    from perfbench.core import runner

    try:
        result, lines = runner.measure(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except runner.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    bad = runner.forbidden_modules()
    if bad:
        print(f"perfbench: loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
