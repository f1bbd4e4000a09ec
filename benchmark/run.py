"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload mpgan30-train --seed 7 --seconds 20 --trace 0

from the root of a checkout that holds the program (``mpgan_tpu_torch``). The
last line of standard output is the result, one JSON object; the last lines
of standard error are the numbers that decided ``correct``, each beside its
limit. Without a CUDA device, or with fewer than the cell asks for, it exits
with 2 and prints no result; if the process has loaded JAX or the JAX package
by the time the window closes, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mpgan_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    needed = harness.cell(ROOT, ns.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < needed:
        print(f"needs {needed} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def no_jax():
        found = loaded_forbidden()
        if found:
            print(f"the process has loaded {found}", file=sys.stderr)
            raise SystemExit(3)

    result = harness.run(ROOT, ns.workload, ns.seed, ns.seconds, bool(ns.trace),
                         torch.device("cuda", 0), T_START, after_window=no_jax)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
