"""``chip_smoke.py``'s phase 30 (the mesh) alone on one card: build the kernels,
then ``chip_smoke.mesh_phase``; a process still running after its time (the
first argument, seconds; a rank: 200) dumps its stacks and exits.

    python3 scripts/torch_mesh_phase.py [SECONDS]
"""
import faulthandler
import pathlib
import sys
import tempfile
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

_rank = cs.mesh_rank


def traced_rank(p):
    faulthandler.dump_traceback_later(200, exit=True)
    return _rank(p)


if __name__ == "__main__":
    from mpgan_tpu_torch.cli import gen, train as train_cli
    from mpgan_tpu_torch.ops import _build, mp_kernels as mk
    from mpgan_tpu_torch.training.config import from_args_dict

    faulthandler.dump_traceback_later(float(sys.argv[1]) if len(sys.argv) > 1 else 600,
                                      exit=True)
    cs.mesh_rank = traced_rank
    torch.backends.cuda.matmul.allow_tf32 = False
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.time()
    _build.library()
    print("build_s", time.time() - t0, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cs.mesh_phase(mk, train_cli, gen, torch.device("cuda"), card, from_args_dict,
                      pathlib.Path(tmp))
    print("MESH PHASE OK", flush=True)
