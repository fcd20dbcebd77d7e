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
  * ref adapters keyed by layer name -> `unet.adapter_key(name)` modules
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from imagdressing_tpu_torch.models.unet import adapter_key

StateDict = Dict[str, torch.Tensor]


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, np.asarray(tree)


def _convert_leaf(path: Tuple[str, ...], arr: np.ndarray
                  ) -> Tuple[str, torch.Tensor]:
    *prefix, last = path
    if arr.dtype.kind not in "fiub":  # e.g. bfloat16 arrays: not numpy's own
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


def parsing_params_from_jax(atr_tree: Any, lip_tree: Any
                            ) -> Tuple[StateDict, StateDict]:
    """The JAX SCHP trees (`preprocess.parsing.model.init` / `convert_torch`)
    of the ATR and LIP nets -> two `preprocess.parsing.model.SCHP` state
    dicts. The module's paths follow the tree's keys (BN `running_mean` /
    `running_var` included), so each leaf maps by its path."""
    return state_dict_from_jax(atr_tree), state_dict_from_jax(lip_tree)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, StateDict]:
    """JAX `DressingModels.params` -> {model name: state dict}, with the
    model names of the JAX tree (unet, ref_unet, ref_adapters, resampler,
    vae, text, vision)."""
    out = {}
    for name, sub in tree.items():
        if name == "ref_adapters":
            sub = {adapter_key(layer): p for layer, p in sub.items()}
        out[name] = state_dict_from_jax(sub)
    return out
