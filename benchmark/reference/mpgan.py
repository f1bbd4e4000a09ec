"""The plain reference of the MPGAN configurations, as a loop asks a
configuration's reference module for it (the configuration's ``reference``):

- ``spec(config)``: what the reference reads of the configuration;
- ``params_of``, ``generator``, ``gen_risky_rows``: G's forward
  (:mod:`.model`);
- ``run_steps``: the first D+G steps of training (:mod:`.step`);
- ``matmul``: the product in the configuration's precision (float32, TF32
  off); ``control_matmul``: the next precision down, the control's (TF32).
"""

from __future__ import annotations

from .model import Spec, gen_risky_rows, generator, matmul, params_of
from .model import matmul_tf32 as control_matmul
from .step import run_steps

__all__ = ["control_matmul", "gen_risky_rows", "generator", "matmul", "params_of", "run_steps",
           "spec"]


def spec(config: dict) -> Spec:
    return Spec.of(config)
