#!/usr/bin/env python
"""Count a built kernel library's SASS instructions by kind, per kernel.

    python scripts/torch_sass_counts.py [--root CHECKOUT] [--match NAME] [--defines D ...]

For a machine with the CUDA toolkit (``cuobjdump``). It builds (or reuses) the
checkout's kernel library and prints, for every kernel whose mangled name holds
``--match`` (default ``tiles_kernel``), one JSON line: its instructions in all
and by kind (``HMMA`` the tensor-core products, ``LDS``/``STS`` shared memory,
``LDG``/``STG``/``LD``/``ST`` device memory (``LD``/``ST`` generic), ``LDL``/``STL``
local memory, that is spills and arrays the compiler could not keep in
registers, ``SHFL``, ``BAR``, ``BRA``). Static counts of the code, not of a run.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

KINDS = ("HMMA", "LDS", "STS", "LDG", "STG", "LD", "ST", "LDL", "STL", "SHFL", "BAR", "BRA")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--match", default="tiles_kernel")
    ap.add_argument("--defines", nargs="*", default=())
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from mpgan_tpu_torch.ops import _build

    lib = _build.build(tuple(args.defines))
    cuobjdump = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if args.match in m.group(1) else None
            if fn:
                counts[fn] = collections.Counter()
            continue
        if fn is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[\w.]*)?", line)
        if m:
            counts[fn]["all"] += 1
            if m.group(1) in KINDS:
                counts[fn][m.group(1)] += 1
    for fn, c in counts.items():
        print(json.dumps({"kernel": re.sub(r"_[0-9a-f]{8}", "_", fn), **c}), flush=True)


if __name__ == "__main__":
    main()
