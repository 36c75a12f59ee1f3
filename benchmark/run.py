"""Run one cell of the benchmark of ``scasml_gp_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  The run sets
the cell up, measures for ``--seconds``, checks the answers against the
plain reference (``benchmark/reference/``) and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; ``checks`` comes
last, each number compared beside its limit, and the same numbers are the
last lines of standard error.  Without a CUDA card (or with fewer cards
than the cell asks for) it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: str = ROOT, device=None, t_start: float = T_START) -> int:
    """Run the cell; ``root`` and ``device`` are for the tests, which run a
    cell on the CPU from a directory of their own."""
    args = parse(argv)
    # every cache of a build or a compile stays inside the checkout, at a
    # fixed path, so that only a checkout's first run builds
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    from benchmark import harness

    run = harness.Run(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      device or "cuda", t_start)
    if device is None:
        chips = int(run.cell.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}",
                  file=sys.stderr)
            return 2
    result = harness.execute(run)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
