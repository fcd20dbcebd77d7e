"""Weights from the JAX package's parameter tree to the port's modules.

`params_from_jax(tree)` takes `DressingModels.params` of the JAX package as
plain nested dicts / lists of `np.ndarray` (no JAX import here) and returns
one PyTorch state dict per model. The port's module attributes follow the
JAX tree's keys, so each leaf maps by its path; only the leaf's layout
changes, once, here:

  * linear `kernel` (in, out)        -> `weight` (out, in)
  * conv `kernel` HWIO               -> `weight` OIHW (loaded into the
                                        port's channels_last parameters)
  * norm `scale`                     -> `weight`
  * `embedding`                      -> `weight`
  * ref and IP adapters keyed by layer name -> `unet.adapter_key(name)`
                                        modules

A leaf may be a numpy array or a torch tensor (the checkpoint converters of
`convert/torch_sd.py` keep a file's tensors in their dtype).
`tree_from_module` is the inverse: a port module's parameters as the JAX
tree, for `convert/export_torch.py`. The JAX CLIs' flat `.npz` files
("p0", "p1", ... in `jax.tree.leaves` order) map by `jax_leaf_order`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from imagdressing_tpu_torch.models.unet import adapter_key
from imagdressing_tpu_torch.ops.nn import (
    Conv2d,
    Embedding,
    Linear,
    Norm,
    Upsample2xConv,
)

StateDict = Dict[str, torch.Tensor]
Leaf = Union[np.ndarray, torch.Tensor]


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Leaf]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif torch.is_tensor(tree):
        yield path, tree
    elif tree is not None:
        yield path, np.asarray(tree)


def _convert_leaf(path: Tuple[str, ...], arr: Leaf
                  ) -> Tuple[str, torch.Tensor]:
    *prefix, last = path
    if torch.is_tensor(arr):
        t = arr.detach()
    else:
        if arr.dtype.kind not in "fiub":  # e.g. bfloat16: not numpy's own
            arr = arr.astype(np.float32)
        t = torch.tensor(arr)
    if last == "kernel":
        if t.ndim == 2:
            t = t.t()
        elif t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        else:
            raise ValueError(f"{'.'.join(path)}: kernel of rank {t.ndim}")
        last = "weight"
    elif last in ("scale", "embedding"):
        last = "weight"
    return ".".join(prefix + [last]), t.contiguous()


def state_dict_from_jax(tree: Any) -> StateDict:
    """One model's JAX parameter tree -> the port module's state dict."""
    return dict(_convert_leaf(p, a) for p, a in _leaves(tree))


# the port's module classes whose `weight` is a JAX `kernel`, `scale` or
# `embedding`; every other parameter keeps its name and layout
_KERNEL_MODULES = (Linear, Conv2d, Upsample2xConv)


def tree_from_module(module: nn.Module) -> Dict[str, Any]:
    """A port module's parameters -> the JAX package's tree of that model
    (nested dicts, lists where the path holds indices), leaves are detached
    torch tensors in the module's dtype and on its device: the exact inverse
    of `state_dict_from_jax`, so `state_dict_from_jax(tree_from_module(m))`
    equals `m.state_dict()`."""
    root: Dict[str, Any] = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            t = p.detach()
            if pname == "weight" and isinstance(mod, _KERNEL_MODULES):
                pname = "kernel"
                t = t.t() if t.ndim == 2 else t.permute(2, 3, 1, 0)
            elif pname == "weight" and isinstance(mod, Norm):
                pname = "scale"
            elif pname == "weight" and isinstance(mod, Embedding):
                pname = "embedding"
            node = root
            for part in (mname.split(".") if mname else []):
                node = node.setdefault(part, {})
            node[pname] = t
    return _lists(root)


def _lists(node: Any) -> Any:
    """Dicts keyed "0".."n-1" -> lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def parsing_params_from_jax(atr_tree: Any, lip_tree: Any
                            ) -> Tuple[StateDict, StateDict]:
    """The JAX SCHP trees (`preprocess.parsing.model.init` / `convert_torch`)
    of the ATR and LIP nets -> two `preprocess.parsing.model.SCHP` state
    dicts. The module's paths follow the tree's keys (BN `running_mean` /
    `running_var` included), so each leaf maps by its path."""
    return state_dict_from_jax(atr_tree), state_dict_from_jax(lip_tree)


def openpose_params_from_jax(tree: Any) -> StateDict:
    """A JAX OpenPose tree (`preprocess.openpose.{model,hand,face}.init` or
    `convert_torch`: {layer name: {kernel HWIO, bias}}) -> the state dict
    of the port's `BodyPoseNet`, `HandPoseNet` or `FaceNet` (OIHW, the same
    layer names)."""
    return state_dict_from_jax(tree)


def detector_params_from_jax(tree: Any) -> StateDict:
    """The JAX person detector's tree (`detect.maskrcnn.init`: backbone,
    fpn, rpn, box_heads, mask; numpy leaves) -> the state dict of the
    port's `detect.maskrcnn.MaskRCNN` (HWIO -> OIHW, (in, out) -> (out,
    in), norm scale -> weight; the module paths are the tree's)."""
    return state_dict_from_jax(tree)


def jax_leaf_order(paths: List[str]) -> List[str]:
    """"/"-joined key paths in `jax.tree.flatten`'s order: dict keys
    sorted at each level, list items by index."""
    def sort_key(path: str) -> Tuple:
        return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                     for p in path.split("/"))

    return sorted(paths, key=sort_key)


def tree_paths(tree: Any) -> Dict[str, Any]:
    """A nested tree -> {"/"-joined key path: leaf}."""
    return {"/".join(p): a for p, a in _leaves(tree)}


def tree_from_flat_leaves(flat: Mapping[str, np.ndarray], paths: List[str]
                          ) -> Dict[str, Any]:
    """A JAX CLI's flat .npz ("p{i}", the i-th leaf in `jax.tree.leaves`
    order) and the tree's key paths -> the nested tree (list levels keyed
    "0", "1", ...; `state_dict_from_jax` reads either)."""
    order = jax_leaf_order(paths)
    if len(flat) != len(order):
        raise ValueError(f"{len(flat)} leaves in the file, the model has "
                         f"{len(order)}")
    root: Dict[str, Any] = {}
    for i, path in enumerate(order):
        *parents, last = path.split("/")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.asarray(flat[f"p{i}"])
    return root


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, StateDict]:
    """JAX `DressingModels.params` -> {model name: state dict}, with the
    model names of the JAX tree (unet, ref_unet, ref_adapters, resampler,
    vae, text, vision, and where present controlnet, ip_adapters,
    proj_plus)."""
    out = {}
    for name, sub in tree.items():
        if name in ("ref_adapters", "ip_adapters"):
            sub = {adapter_key(layer): p for layer, p in sub.items()}
        out[name] = state_dict_from_jax(sub)
    return out


def train_state_from_jax(template, params: Dict[str, Any], *,
                         mu: Optional[Dict[str, Any]] = None,
                         nu: Optional[Dict[str, Any]] = None,
                         step: int = 0, count: int = 0):
    """A JAX `TrainState`'s trainables and AdamW moments -> the port's
    per-rank state: `params`, `mu` and `nu` are trees of numpy arrays in the
    JAX layout with the `TRAINABLE_KEYS` entries (the JAX package's
    `shard_train_step` state gathered to the host; zero moments where not
    given), `count` the AdamW step count. `template` (a whole, ZeRO-2 or
    tensor-parallel `train.step.TrainState`) fixes the flat order and each
    rank's part, which `train.step.state_from_host` keeps."""
    import dataclasses

    from imagdressing_tpu_torch.train import step as tstep

    keys = tstep.TRAINABLE_KEYS
    sds = params_from_jax({k: params[k] for k in keys})
    flats = {}
    for what, tree in (("mu", mu), ("nu", nu)):
        if tree is None:
            continue
        moments = params_from_jax({k: tree[k] for k in keys})
        flats[what] = torch.cat([
            moments[k][n].reshape(-1).float() for k in keys
            for n, _ in template.params[k].named_parameters()])
    n = sum(t.numel() for sd in sds.values() for t in sd.values())
    opt = {f.name: getattr(template.opt_state, f.name)
           for f in dataclasses.fields(tstep.OptState)}
    for what in ("mu", "nu", "acc_grads"):
        if opt[what] is not None:
            opt[what] = flats.get(what, torch.zeros(n)).to(opt[what].dtype)
    opt["count"] = int(count)
    return tstep.state_from_host(
        template, {"step": int(step), "params": sds, "opt_state": opt})
