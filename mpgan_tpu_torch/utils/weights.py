"""Generator weights: the JAX package's pytrees, and the reference's ``.pt`` files.

The port's modules carry the reference's submodule names, so a reference
``G_*.pt`` state dict loads with ``load_state_dict(strict=True)``. The layout,
per ``LinearNet`` at ``prefix`` (``mp_layers.{i}.fe.``, ``mp_layers.{i}.fn.``,
``fmg_layer.``), against the JAX pytrees (``mpgan_tpu/utils/torch_import.py``):

==================================================  ==================================
reference / port key                                JAX params / state
==================================================  ==================================
``net.{k}.weight``, ``net.{k}.bias``                ``layers[k].w``, ``layers[k].b``
``net.{k}.module.weight_bar``, ``.module.bias``     ``layers[k].w``, ``layers[k].b`` (SN)
``net.{k}.module.weight_u``                         ``sn_u[k]``
``net.{k}.module.weight_v``                         derived: ``normalize(w.T @ u)``
``bn.{j}.weight``, ``bn.{j}.bias``                  ``bn[j].scale``, ``bn[j].bias``
``bn.{j}.running_mean``, ``bn.{j}.running_var``     state ``bn[j].mean``, ``bn[j].var``
``bn.{j}.num_batches_tracked``                      not carried (0)
``lfc_layer.weight``, ``lfc_layer.bias``            ``lfc.w``, ``lfc.b``
==================================================  ==================================
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..models.mpgan import MPGenerator, MPGeneratorConfig
from ..ops.linear import MLPConfig


def _tensors(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def mlp_sd_from_jax(prefix: str, cfg: MLPConfig, params: Mapping,
                    state: Mapping) -> dict[str, torch.Tensor]:
    """One ``LinearNet``'s JAX pytrees (numpy leaves) as reference-layout keys under ``prefix``."""
    sd: dict[str, np.ndarray] = {}
    bn_idx = 0
    for k in range(cfg.num_layers):
        w = np.asarray(params["layers"][k]["w"], np.float32)
        b = np.asarray(params["layers"][k]["b"], np.float32)
        if cfg.layer_has_sn(k):
            base = f"{prefix}net.{k}.module."
            u = np.asarray(state["sn_u"][k], np.float32)
            v = w.T @ u
            sd[base + "weight_bar"], sd[base + "bias"] = w, b
            sd[base + "weight_u"] = u
            sd[base + "weight_v"] = (v / (np.linalg.norm(v) + 1e-12)).astype(np.float32)
        else:
            sd[f"{prefix}net.{k}.weight"], sd[f"{prefix}net.{k}.bias"] = w, b
        if cfg.batch_norm and cfg.layer_has_activation(k):
            bn = f"{prefix}bn.{bn_idx}."
            sd[bn + "weight"] = np.asarray(params["bn"][bn_idx]["scale"], np.float32)
            sd[bn + "bias"] = np.asarray(params["bn"][bn_idx]["bias"], np.float32)
            sd[bn + "running_mean"] = np.asarray(state["bn"][bn_idx]["mean"], np.float32)
            sd[bn + "running_var"] = np.asarray(state["bn"][bn_idx]["var"], np.float32)
            sd[bn + "num_batches_tracked"] = np.asarray(0, np.int64)
            bn_idx += 1
    return _tensors(sd)


def reference_sd_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                          cfg: MPGeneratorConfig) -> dict[str, torch.Tensor]:
    """JAX generator pytrees (numpy leaves) as a reference-layout state dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, layer_cfg in enumerate(cfg.layers):
        p, s = params["mp_layers"][i], state["mp_layers"][i]
        sd.update(mlp_sd_from_jax(f"mp_layers.{i}.fe.", layer_cfg.fe, p["fe"], s["fe"]))
        sd.update(mlp_sd_from_jax(f"mp_layers.{i}.fn.", layer_cfg.fn, p["fn"], s["fn"]))
    if cfg.lfc:
        sd.update(_tensors({"lfc_layer.weight": np.asarray(params["lfc"]["w"], np.float32),
                            "lfc_layer.bias": np.asarray(params["lfc"]["b"], np.float32)}))
    if cfg.fmg_cfg is not None:
        sd.update(mlp_sd_from_jax("fmg_layer.", cfg.fmg_cfg, params["fmg"], state.get("fmg", {})))
    return sd


def mp_generator_from_jax(
    params: Mapping[str, Any], state: Mapping[str, Any], cfg: MPGeneratorConfig,
    device: torch.device | str = "cpu",
) -> MPGenerator:
    """An :class:`MPGenerator` holding the weights of JAX ``(params, state)`` pytrees."""
    g = MPGenerator(cfg, device=device)
    g.load_state_dict(reference_sd_from_jax(params, state, cfg), strict=True)
    return g


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a reference ``G_*.pt`` state dict (tensors only) onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    return dict(sd)


def mp_generator_to_reference_sd(module: MPGenerator) -> dict[str, torch.Tensor]:
    """The module's weights as a reference-layout state dict on the CPU (``torch.save``-able)."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
