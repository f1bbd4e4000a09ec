"""Model weights: the JAX package's pytrees, and the reference's ``.pt`` files.

The port's modules carry the reference's submodule names, so a reference
``G_*.pt`` or ``D_*.pt`` state dict loads with ``load_state_dict(strict=True)``.
The layout, per ``LinearNet`` at ``prefix`` (``mp_layers.{i}.fe.``,
``mp_layers.{i}.fn.``, ``fmg_layer.``, and the discriminator's head
``fnd_layer.``), against the JAX pytrees (``mpgan_tpu/utils/torch_import.py``):

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

GAPT (``sabs.{i}.mab.``, with ISAB ``sabs.{i}.mab0.`` / ``mab1.`` and
``sabs.{i}.I``; the discriminator's ``pma.mab.`` and ``pma.S``; the LinearNets
``final_fc.``, ``input_embedding.`` and each MAB's ``ff.`` as above):

==================================================  ==================================
``attention.in_proj_weight``, ``.in_proj_bias``     ``attention.in_proj_w``, ``.in_proj_b``
``attention.out_proj.weight``, ``.out_proj.bias``   ``attention.out_w``, ``.out_b``
``norm1.weight``, ``norm1.bias`` (and ``norm2``)    ``norm1.scale``, ``norm1.bias``
==================================================  ==================================

:func:`jax_leaves` lists a module's tensors in the order ``jax.tree.flatten``
visits the JAX params (or mutable state) pytree: dict keys sorted (``bn``
before ``layers``, ``b`` before ``w``, ``bias`` before ``scale``, ``fmg`` and
``lfc`` before ``mp_layers``, ``fnd`` before ``mp_layers``; GAPT: ``final_fc``,
``input_embedding``, ``pma/{S, mab}``, ``sabs/[i]/mab/{attention/{in_proj_b,
in_proj_w, out_b, out_w}, ff, norm1, norm2}``, with ISAB ``I``, ``mab0``,
``mab1``), ``None`` entries skipped. The checkpoint layout shared with the JAX
package rests on it. The other families, params then state:

================  =================================================================
rGAN G, PCGAN     ``layers[i]/{b, w}``
rGAN D            ``fc[i]/{b, w}``, then ``sfc[i]/{b, w}``
PointNet D        ``fc[i]/{b, w}``, then ``pointfc[i]/{b, w}``
TreeGAN G         per depth ``bias, w_branch, w_loop1, w_loop2, w_root[i]``
GraphCNN G        ``bn[i]/{bias, scale}``, ``convs[i]/{edge, root}/{b, w}``,
                  ``dense/{b, w}``; state ``bn[i]/{mean, var}``
legacy MPGAN      ``fmg``, ``fnd``, ``lfc/{b, w}``, ``mp_layers[i]/{fe, fn}``
================  =================================================================

:func:`load_jax_trees` copies any family's JAX ``(params, state)`` pytrees
(numpy leaves, flattened here in the same order, no JAX needed) into a module.
:func:`reference_state_dict` and :func:`generator_from_reference` write and
read the reference's ``.pt`` layout of every generator family
(``mpgan_tpu/utils/torch_import.py``); most modules carry it as their own
``state_dict``, GraphCNN (``layers.{i}.root`` is ``[in, out]``) and the legacy
MPGAN (``fe.{i}.{j}``, ``fn.{i}.{j}``, ``fnd.{j}``, ``fmg.{j}``) are mapped.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

import re

from ..models.ext.graphcnn import GraphCNNGenerator
from ..models.ext.pcgan import LatentDiscriminator, LatentGenerator
from ..models.ext.pointnet import PointNetMixDiscriminator
from ..models.ext.rgan import RGANDiscriminator, RGANGenerator, linear_layers
from ..models.ext.treegan import TreeGANGenerator
from ..models.gapt import SAB, GAPTConfig, GAPTDiscriminator, GAPTGenerator
from ..models.old_mpgan import OldMPGAN
from ..models.mpgan import (
    MPDiscriminator,
    MPDiscriminatorConfig,
    MPGenerator,
    MPGeneratorConfig,
)
from ..ops.attention import MAB
from ..ops.linear import MLP, MLPConfig, SNLinear


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


def discriminator_sd_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                              cfg: MPDiscriminatorConfig) -> dict[str, torch.Tensor]:
    """JAX discriminator pytrees (numpy leaves) as a reference-layout state dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, layer_cfg in enumerate(cfg.layers):
        p, s = params["mp_layers"][i], state["mp_layers"][i]
        sd.update(mlp_sd_from_jax(f"mp_layers.{i}.fe.", layer_cfg.fe, p["fe"], s["fe"]))
        sd.update(mlp_sd_from_jax(f"mp_layers.{i}.fn.", layer_cfg.fn, p["fn"], s["fn"]))
    if cfg.fnd_cfg is not None:
        sd.update(mlp_sd_from_jax("fnd_layer.", cfg.fnd_cfg, params["fnd"], state.get("fnd", {})))
    return sd


def mp_discriminator_from_jax(
    params: Mapping[str, Any], state: Mapping[str, Any], cfg: MPDiscriminatorConfig,
    device: torch.device | str = "cpu",
) -> MPDiscriminator:
    """An :class:`MPDiscriminator` holding the weights of JAX ``(params, state)`` pytrees."""
    d = MPDiscriminator(cfg, device=device)
    d.load_state_dict(discriminator_sd_from_jax(params, state, cfg), strict=True)
    return d


def _mab_sd_from_jax(prefix: str, cfg: GAPTConfig, params: Mapping,
                     state: Mapping) -> dict[str, torch.Tensor]:
    att = params["attention"]
    sd = _tensors({
        prefix + "attention.in_proj_weight": np.asarray(att["in_proj_w"], np.float32),
        prefix + "attention.in_proj_bias": np.asarray(att["in_proj_b"], np.float32),
        prefix + "attention.out_proj.weight": np.asarray(att["out_w"], np.float32),
        prefix + "attention.out_proj.bias": np.asarray(att["out_b"], np.float32),
    })
    mab_cfg = cfg.mab_cfg()
    sd.update(mlp_sd_from_jax(prefix + "ff.", mab_cfg.ff, params["ff"], state["ff"]))
    if mab_cfg.layer_norm:
        for name in ("norm1", "norm2"):
            sd.update(_tensors({
                f"{prefix}{name}.weight": np.asarray(params[name]["scale"], np.float32),
                f"{prefix}{name}.bias": np.asarray(params[name]["bias"], np.float32),
            }))
    return sd


def gapt_sd_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                     cfg: GAPTConfig) -> dict[str, torch.Tensor]:
    """JAX GAPT generator or discriminator pytrees (numpy leaves) as a
    reference-layout state dict."""
    sd: dict[str, torch.Tensor] = {}
    for i in range(cfg.sab_layers):
        p, s = params["sabs"][i], state["sabs"][i]
        if cfg.use_isab:
            sd.update(_tensors({f"sabs.{i}.I": np.asarray(p["I"], np.float32)}))
            sd.update(_mab_sd_from_jax(f"sabs.{i}.mab0.", cfg, p["mab0"], s["mab0"]))
            sd.update(_mab_sd_from_jax(f"sabs.{i}.mab1.", cfg, p["mab1"], s["mab1"]))
        else:
            sd.update(_mab_sd_from_jax(f"sabs.{i}.mab.", cfg, p["mab"], s["mab"]))
    sd.update(mlp_sd_from_jax("final_fc.", cfg.final_fc_cfg(), params["final_fc"],
                              state["final_fc"]))
    if not cfg.is_generator:
        sd.update(mlp_sd_from_jax("input_embedding.", cfg.embed_cfg(),
                                  params["input_embedding"], state["input_embedding"]))
        sd.update(_tensors({"pma.S": np.asarray(params["pma"]["S"], np.float32)}))
        sd.update(_mab_sd_from_jax("pma.mab.", cfg, params["pma"]["mab"], state["pma"]))
    return sd


def gapt_generator_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                            cfg: GAPTConfig, device: torch.device | str = "cpu"
                            ) -> GAPTGenerator:
    """A :class:`GAPTGenerator` holding the weights of JAX ``(params, state)`` pytrees."""
    g = GAPTGenerator(cfg, device=device)
    g.load_state_dict(gapt_sd_from_jax(params, state, cfg), strict=True)
    return g


def gapt_discriminator_from_jax(params: Mapping[str, Any], state: Mapping[str, Any],
                                cfg: GAPTConfig, device: torch.device | str = "cpu"
                                ) -> GAPTDiscriminator:
    """A :class:`GAPTDiscriminator` holding the weights of JAX ``(params, state)`` pytrees."""
    d = GAPTDiscriminator(cfg, device=device)
    d.load_state_dict(gapt_sd_from_jax(params, state, cfg), strict=True)
    return d


def _mlp_leaves(mlp: MLP, params: bool) -> list[torch.Tensor]:
    cfg = mlp.cfg
    out: list[torch.Tensor] = []
    if params:
        if cfg.batch_norm:
            for bn in mlp.bn:
                out += [bn.bias, bn.weight]  # "bias" < "scale"
        for lin in mlp.net:
            m = lin.module if isinstance(lin, SNLinear) else lin
            out += [m.bias, m.weight_bar if isinstance(lin, SNLinear) else m.weight]
    else:
        if cfg.batch_norm:
            for bn in mlp.bn:
                out += [bn.running_mean, bn.running_var]
        if cfg.spectral_norm:
            out += [lin.module.weight_u for lin in mlp.net if isinstance(lin, SNLinear)]
    return out


def _mab_leaves(mab: MAB, params: bool) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    if params:
        att = mab.attention
        out += [att.in_proj_bias, att.in_proj_weight, att.out_proj.bias, att.out_proj.weight]
    out += _mlp_leaves(mab.ff, params)
    if params and mab.cfg.layer_norm:
        out += [mab.norm1.bias, mab.norm1.weight, mab.norm2.bias, mab.norm2.weight]
    return out


def _sab_leaves(sab: SAB, params: bool) -> list[torch.Tensor]:
    if not sab.cfg.use_isab:
        return _mab_leaves(sab.mab, params)
    return ([sab.I] if params else []) + _mab_leaves(sab.mab0, params) \
        + _mab_leaves(sab.mab1, params)


def _gapt_leaves(model: GAPTGenerator | GAPTDiscriminator, params: bool) -> list[torch.Tensor]:
    out = _mlp_leaves(model.final_fc, params)
    if isinstance(model, GAPTDiscriminator):
        out += _mlp_leaves(model.input_embedding, params)
        out += ([model.pma.S] if params else []) + _mab_leaves(model.pma.mab, params)
    for sab in model.sabs:
        out += _sab_leaves(sab, params)
    return out


def _linear_leaves(layers, params: bool) -> list[torch.Tensor]:
    return [t for lin in layers for t in (lin.bias, lin.weight)] if params else []


def _ext_leaves(model: torch.nn.Module, params: bool) -> list[torch.Tensor] | None:
    """The external families' leaves, None for another module."""
    if isinstance(model, (RGANGenerator, LatentGenerator, LatentDiscriminator)):
        return _linear_leaves(linear_layers(model.model), params)
    if isinstance(model, RGANDiscriminator):
        return _linear_leaves(model.fc, params) + _linear_leaves(model.sfc, params)
    if isinstance(model, PointNetMixDiscriminator):
        return _linear_leaves(model.fc, params) + _linear_leaves(model.pointfc, params)
    if isinstance(model, TreeGANGenerator):
        if not params:
            return []
        return [t for layer in model.gcn for t in (
            layer.bias, layer.W_branch, layer.W_loop[0].weight, layer.W_loop[1].weight,
            *(lin.weight for lin in layer.W_root))]
    if isinstance(model, GraphCNNGenerator):
        if not params:
            return [t for bn in model.bn_layers for t in (bn.running_mean, bn.running_var)]
        out = [t for bn in model.bn_layers for t in (bn.bias, bn.weight)]
        out += [t for conv in model.layers for t in (
            conv.nn.bias, conv.nn.weight, conv.root.bias, conv.root.weight)]
        return out + [model.dense.bias, model.dense.weight]
    if isinstance(model, OldMPGAN):
        out = []
        if model.cfg.fmg_cfg is not None:
            out += _mlp_leaves(model.fmg, params)
        if model.cfg.fnd_cfg is not None:
            out += _mlp_leaves(model.fnd, params)
        if model.cfg.lfc and params:
            out += [model.lfc.bias, model.lfc.weight]
        for layer in model.mp_layers:
            out += _mlp_leaves(layer.fe, params) + _mlp_leaves(layer.fn, params)
        return out
    return None


def jax_leaves(model: torch.nn.Module, params: bool) -> list[torch.Tensor]:
    """The module's parameters (``params=True``) or mutable state (BN running
    statistics, SN ``u``) in the JAX pytree's flatten order."""
    if isinstance(model, (GAPTGenerator, GAPTDiscriminator)):
        return _gapt_leaves(model, params)
    ext = _ext_leaves(model, params)
    if ext is not None:
        return ext
    out: list[torch.Tensor] = []
    if isinstance(model, MPDiscriminator):
        if model.cfg.fnd_cfg is not None:
            out += _mlp_leaves(model.fnd_layer, params)
    else:
        if model.cfg.fmg_cfg is not None:
            out += _mlp_leaves(model.fmg_layer, params)
        if model.cfg.lfc and params:
            out += [model.lfc_layer.bias, model.lfc_layer.weight]
    for layer in model.mp_layers:
        out += _mlp_leaves(layer.fe, params) + _mlp_leaves(layer.fn, params)
    return out


def tree_leaves(tree: Any) -> list[np.ndarray]:
    """The leaves of a nested dict / list / tuple in ``jax.tree.leaves`` order:
    dict keys sorted, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [np.asarray(tree)]


def load_jax_trees(model: torch.nn.Module, params: Any, state: Any) -> torch.nn.Module:
    """Copy JAX ``(params, state)`` pytrees (numpy leaves) into ``model`` in place,
    through :func:`jax_leaves`; shapes must agree. Returns ``model``."""
    with torch.no_grad():
        for tree, is_params in ((params, True), (state, False)):
            leaves, ours = tree_leaves(tree), jax_leaves(model, is_params)
            if len(leaves) != len(ours):
                raise ValueError(f"{type(model).__name__}: {len(leaves)} JAX leaves, "
                                 f"{len(ours)} in the module")
            for t, leaf in zip(ours, leaves):
                if tuple(leaf.shape) != tuple(t.shape):
                    raise ValueError(f"leaf shape {leaf.shape} != {tuple(t.shape)}")
                t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    refresh_sn_v(model)
    return model


# the legacy MPGAN's reference keys against the module's (old_model.py)
_OLD_KEYS = ((r"^mp_layers\.(\d+)\.(fe|fn)\.net\.", r"\2.\1."), (r"^(fnd|fmg)\.net\.", r"\1."))
_OLD_KEYS_BACK = ((r"^(fe|fn)\.(\d+)\.", r"mp_layers.\2.\1.net."), (r"^(fnd|fmg)\.", r"\1.net."))


def _rename(sd: Mapping[str, torch.Tensor], rules) -> dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for pat, rep in rules:
            k, n = re.subn(pat, rep, k)
            if n:
                break
        out[k] = v
    return out


def reference_state_dict(model: str, module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A generator's weights in the reference's ``G_*.pt`` layout, on the CPU
    (``torch.save``-able): what ``mpgan_tpu.utils.torch_import.generator_from_torch``
    reads for ``model``."""
    sd = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
    if model == "old_mpgan":
        return _rename(sd, _OLD_KEYS)
    if model == "graphcnngan":
        out = {}
        for k, v in sd.items():
            if k.endswith(".root.weight"):
                out[k[: -len(".weight")]] = v.t().contiguous()
            elif k.endswith(".root.bias"):
                out[k[: -len(".root.bias")] + ".bias"] = v
            elif k.startswith("bn_layers."):
                i, rest = k[len("bn_layers."):].split(".", 1)
                out[f"bn_layers.{i}.module.{rest}"] = v
            else:
                out[k] = v
        return out
    return sd


def _module_sd(model: str, sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """:func:`reference_state_dict`'s inverse."""
    if model == "old_mpgan":
        if any(k.startswith("mp_layers.") for k in sd):
            raise ValueError(
                "this old_mpgan state dict is in the modern MPGAN layout (mp_layers.*, as the "
                "shipped mplfc checkpoints): load it with the card's model set to mpgan")
        return _rename(sd, _OLD_KEYS_BACK)
    if model == "graphcnngan":
        out = {}
        for k, v in sd.items():
            parts = k.split(".")
            if k.startswith("layers.") and parts[2] == "root":
                out[f"layers.{parts[1]}.root.weight"] = v.t().contiguous()
            elif k.startswith("layers.") and parts[2] == "bias":
                out[f"layers.{parts[1]}.root.bias"] = v
            elif k.startswith("bn_layers."):
                out[k.replace(".module.", ".", 1)] = v
            else:
                out[k] = v
        return out
    return dict(sd)


def generator_from_reference(model: str, sd: Mapping[str, torch.Tensor], cfg: Any,
                             g_cls: type, device: torch.device | str = "cpu"
                             ) -> torch.nn.Module:
    """A ``g_cls(cfg)`` generator holding a reference-layout state dict (the
    counterpart of ``generator_from_torch``). Spectral-norm ``weight_v`` and BN
    ``num_batches_tracked`` may be missing; any other missing or unexpected key
    raises."""
    g = g_cls(cfg)
    missing, unexpected = g.load_state_dict(_module_sd(model, sd), strict=False)
    missing = [k for k in missing if not k.endswith(("weight_v", "num_batches_tracked"))]
    if missing or unexpected:
        raise KeyError(f"{model} state dict: missing {missing}, unexpected {unexpected}")
    refresh_sn_v(g)
    return g.to(device)


def refresh_sn_v(model: torch.nn.Module) -> None:
    """Recompute every spectral-norm ``weight_v = normalize(w^T u)`` after ``u``
    was loaded (the JAX package carries ``u`` only)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SNLinear):
                m = mod.module
                v = m.weight_bar.t() @ m.weight_u
                m.weight_v.copy_(v / (torch.linalg.vector_norm(v) + 1e-12))


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a reference ``G_*.pt`` state dict (tensors only) onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    return dict(sd)


def gapt_generator_to_reference_sd(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A GAPT generator's or discriminator's weights as a reference-layout state
    dict on the CPU (``torch.save``-able): the module's own keys."""
    return mp_generator_to_reference_sd(module)


def mp_generator_to_reference_sd(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A generator's or discriminator's weights as a reference-layout state dict
    on the CPU (``torch.save``-able)."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def particlenet_from_jax(params: Any) -> dict[str, Any]:
    """The JAX package's ``particlenet_init`` tree (numpy leaves) as the port's
    FPND trunk: the same tree with float32 tensors for leaves."""
    from ..evaluation.fpnd import params_to

    return params_to(params, "cpu")


_PNET_PROBE = "edge_convs.0.convs.0.weight"


def load_particlenet(path: str) -> dict[str, Any]:
    """Read a jetnet ``pnet_state_dict.pt`` (tensors only, ``weights_only``)
    into the FPND trunk, in the key schema of the JAX package's
    ``load_particlenet`` (``mpgan_tpu/evaluation/fpnd.py:141-200``): the input
    ``bn_fts.*``, per block ``edge_convs.{i}.convs.{j}.weight`` (1x1 Conv2d,
    ``[out, in, 1, 1]``) with ``bns.{j}.*``, the shortcut ``sc.weight`` and
    ``sc_bn.*``. A file without them raises ``KeyError`` listing the keys found."""
    from ..evaluation.fpnd import CONV_WIDTHS

    sd = load_reference_state_dict(path)
    if _PNET_PROBE not in sd:
        raise KeyError(
            f"state dict at {path} does not match the expected ParticleNet "
            f"schema (missing '{_PNET_PROBE}'). Found keys: "
            f"{sorted(sd.keys())[:20]}... Expected weaver-style keys: "
            "bn_fts.*, edge_convs.{i}.convs.{j}.weight, edge_convs.{i}."
            "bns.{j}.*, edge_convs.{i}.sc.weight, edge_convs.{i}.sc_bn.*"
        )

    def bn(prefix: str, out: str = "") -> dict[str, torch.Tensor]:
        return {out + "scale": sd[f"{prefix}.weight"], out + "bias": sd[f"{prefix}.bias"],
                out + "mean": sd[f"{prefix}.running_mean"],
                out + "var": sd[f"{prefix}.running_var"]}

    params: dict[str, Any] = {"input_bn": bn("bn_fts"), "edge_convs": []}
    for bi, widths in enumerate(CONV_WIDTHS):
        base = f"edge_convs.{bi}"
        convs = [{"w": sd[f"{base}.convs.{wi}.weight"].reshape(w, -1),
                  **bn(f"{base}.bns.{wi}", "bn_")} for wi, w in enumerate(widths)]
        shortcut = {"w": sd[f"{base}.sc.weight"].reshape(widths[-1], -1),
                    **bn(f"{base}.sc_bn", "bn_")}
        params["edge_convs"].append({"convs": convs, "shortcut": shortcut})
    return params
