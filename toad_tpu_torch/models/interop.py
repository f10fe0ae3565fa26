"""Weights in and out of the port's :class:`~toad_tpu_torch.models.toad_mil.ToadMIL`,
and the JAX encoders' weights into
:class:`~toad_tpu_torch.models.vit_encoder.ViTEncoder` (:func:`vit_params_from_jax`)
and :class:`~toad_tpu_torch.models.resnet_encoder.ResNetEncoder`
(:func:`resnet_params_from_jax`).

Two sources for ToadMIL:

- a reference ``s_{fold}_checkpoint.pt`` state_dict (PyTorch counterpart of
  :mod:`toad_tpu.models.torch_interop`). Its trunk and attention sit in one
  ``nn.Sequential`` named ``attention_net`` whose indices shift with the
  dropout flag: fc2 and the gated attention are ``attention_net.{2,4}``
  without dropout and ``attention_net.{3,6}`` with it. ``nn.DataParallel``
  leaves ``module.`` segments, which are stripped.
- the JAX package's params pytree (:func:`params_from_jax`), with [in, out]
  weights; it carries the weights across for every parity test, and
  :func:`params_to_jax_layout` and :func:`optimizer_state_from_jax` carry
  parameters back and optimizer state across for the training ones. Its int8
  pooling weights (``toad_tpu.ops.quantize.quantize_pool_params``) cross with
  :func:`qparams_from_jax`, so that both packages run the same integers.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from toad_tpu_torch.config import ModelConfig

# reference Linear name (after the attention_net index is resolved) -> port prefix
_REFERENCE_NAMES = (
    ("attention_net.0", "trunk.fc1"),
    ("attention_net.{fc2}", "trunk.fc2"),
    ("attention_net.{attn}.attention_a.0", "attn.a"),
    ("attention_net.{attn}.attention_b.0", "attn.b"),
    ("attention_net.{attn}.attention_c", "attn.c"),
    ("classifier", "cls_head"),
    ("site_classifier", "site_head"),
)


def _strip_module(sd: Mapping[str, Any]) -> dict[str, Any]:
    return {k.replace(".module.", ".").removeprefix("module."): v for k, v in sd.items()}


def _f32(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def _detect_indices(sd: Mapping[str, Any]) -> tuple[int, int]:
    """(fc2_idx, attn_idx): (3, 6) when the model was built with dropout,
    (2, 4) without."""
    if any(k.startswith("attention_net.3.") for k in sd):
        return 3, 6
    if any(k.startswith("attention_net.2.") for k in sd):
        return 2, 4
    raise KeyError("state dict has no attention_net.{2|3}.* keys: not a TOAD checkpoint")


def state_dict_from_reference(sd: Mapping[str, Any], config: ModelConfig | None = None) -> dict[str, torch.Tensor]:
    """Reference state_dict -> the port's state_dict, f32. Strict on the keys
    the model needs, tolerant of extras. A dict holding the model under
    ``state_dict`` is unwrapped."""
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    sd = _strip_module(sd)
    fc2, attn = _detect_indices(sd)
    out: dict[str, torch.Tensor] = {}
    for ref, port in _REFERENCE_NAMES:
        ref = ref.format(fc2=fc2, attn=attn)
        for part in ("weight", "bias"):
            out[f"{port}.{part}"] = _f32(sd[f"{ref}.{part}"])
    if config is not None:
        check_shapes(out, config)
    return out


def reference_state_dict(sd: Mapping[str, torch.Tensor], dropout: bool = True) -> dict[str, torch.Tensor]:
    """The port's state_dict -> the reference layout (``attention_net.{3,6}``
    with ``dropout``, ``{2,4}`` without), as ``s_{fold}_checkpoint.pt`` holds it."""
    fc2, attn = (3, 6) if dropout else (2, 4)
    return {
        f"{ref.format(fc2=fc2, attn=attn)}.{part}": sd[f"{port}.{part}"].detach().cpu().float()
        for ref, port in _REFERENCE_NAMES
        for part in ("weight", "bias")
        if f"{port}.{part}" in sd  # an un-gated model has no attn.b
    }


def params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ToadMIL params pytree (numpy-convertible leaves, [in, out]
    weights) -> the port's state_dict (f32, [out, in] weights)."""
    groups = {"trunk": params["trunk"], "attn": params["attn"],
              "cls_head": {"": params["cls_head"]}, "site_head": {"": params["site_head"]}}
    out: dict[str, torch.Tensor] = {}
    for group, lins in groups.items():
        for name, lin in lins.items():
            prefix = f"{group}.{name}" if name else group
            out[f"{prefix}.weight"] = _f32(np.asarray(lin["w"], np.float32).T)
            out[f"{prefix}.bias"] = _f32(lin["b"])
    return out


def params_to_jax_layout(model: torch.nn.Module) -> dict[str, Any]:
    """The model's parameters as the nested numpy dict of the JAX
    ``ToadMIL.init`` (f32, [in, out] weights), so that both packages'
    parameters can be compared leaf by leaf."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}

    def lin(prefix: str) -> dict[str, np.ndarray]:
        return {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T), "b": sd[f"{prefix}.bias"]}

    groups = {g: sorted({k.split(".")[1] for k in sd if k.startswith(g + ".")}) for g in ("trunk", "attn")}
    return {
        **{g: {name: lin(f"{g}.{name}") for name in names} for g, names in groups.items()},
        "cls_head": lin("cls_head"),
        "site_head": lin("site_head"),
    }


def optimizer_state_from_jax(opt_state: Any, model: torch.nn.Module) -> dict[int, dict[str, torch.Tensor]]:
    """The state of the JAX package's optimizer (the optax chain of
    ``toad_tpu.train.optim.make_optimizer``, its leaves numpy-convertible)
    -> the ``state`` entry of the port optimizer's ``state_dict()``, keyed by
    the position of each parameter in ``model.parameters()``: Adam's ``mu``,
    ``nu`` and ``count`` become ``exp_avg``, ``exp_avg_sq`` and ``step``,
    SGD's ``trace`` becomes ``momentum_buffer``; weights go [in, out] ->
    [out, in]. Load it with::

        sd = optimizer.state_dict()
        sd["state"] = optimizer_state_from_jax(opt_state, model)
        optimizer.load_state_dict(sd)
    """
    parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = next((p for p in parts if hasattr(p, "mu") and hasattr(p, "nu")), None)
    sgd = next((p for p in parts if hasattr(p, "trace")), None)
    if adam is None and sgd is None:
        raise ValueError("optimizer state holds neither Adam's mu/nu nor SGD's trace")
    trees = ({"exp_avg": params_from_jax(adam.mu), "exp_avg_sq": params_from_jax(adam.nu)} if adam is not None
             else {"momentum_buffer": params_from_jax(sgd.trace)})
    state: dict[int, dict[str, torch.Tensor]] = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        state[i] = {k: tree[name].to(p.device) for k, tree in trees.items()}
        if adam is not None:
            state[i]["step"] = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return state


def qparams_from_jax(qparams: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX int8 pooling weights (numpy-convertible leaves, keyed
    ``w1q/sw1/b1, w2q/sw2/b2, wabq/swab/bab, wc/bc``, [in, out] layout) ->
    the same dict of torch tensors: int8 weights stay int8, the rest f32."""
    out: dict[str, torch.Tensor] = {}
    for name, v in qparams.items():
        arr = np.asarray(v)
        out[name] = torch.from_numpy(np.array(arr, np.int8 if arr.dtype == np.int8 else np.float32))
    return out


def vit_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ViT encoder's params pytree (numpy-convertible leaves; weights
    [in, out], the patch-embed kernel HWIO, LayerNorm as scale/bias) -> the
    state_dict of the port's ``ViTEncoder`` (f32; nn.Linear [out, in], Conv2d
    OIHW, timm's names)."""

    def lin(prefix: str, p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        return {f"{prefix}.weight": _f32(np.asarray(p["w"], np.float32).T), f"{prefix}.bias": _f32(p["b"])}

    def norm(prefix: str, p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        return {f"{prefix}.weight": _f32(p["scale"]), f"{prefix}.bias": _f32(p["bias"])}

    out = {
        "patch_embed.proj.weight": _f32(np.asarray(params["patch_embed"]["w"], np.float32).transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _f32(params["patch_embed"]["b"]),
        "cls_token": _f32(params["cls_token"]),
        "pos_embed": _f32(params["pos_embed"]),
        **norm("norm", params["norm"]),
    }
    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        out.update({**norm(f"{p}.norm1", blk["norm1"]), **lin(f"{p}.attn.qkv", blk["qkv"]),
                    **lin(f"{p}.attn.proj", blk["proj"]), **norm(f"{p}.norm2", blk["norm2"]),
                    **lin(f"{p}.mlp.fc1", blk["fc1"]), **lin(f"{p}.mlp.fc2", blk["fc2"])})
        if "ls1" in blk:
            out[f"{p}.ls1.gamma"], out[f"{p}.ls2.gamma"] = _f32(blk["ls1"]), _f32(blk["ls2"])
    return out


def resnet_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ResNet-50 encoder's params pytree (numpy-convertible leaves;
    conv kernels HWIO), unfolded (``bn``/``bnX`` dicts of scale, bias, mean,
    var) or BN-folded (``bias``/``biasX``) -> the state_dict of the port's
    ``ResNetEncoder`` in the same form (f32; OIHW, torchvision's names)."""

    def conv(prefix: str, w: Any) -> dict[str, torch.Tensor]:
        return {f"{prefix}.weight": _f32(np.asarray(w, np.float32).transpose(3, 2, 0, 1))}

    def bn(prefix: str, p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        return {f"{prefix}.weight": _f32(p["scale"]), f"{prefix}.bias": _f32(p["bias"]),
                f"{prefix}.running_mean": _f32(p["mean"]), f"{prefix}.running_var": _f32(p["var"])}

    def conv_bn(conv_name: str, bn_name: str, w: Any, p: Mapping[str, Any], bn_key: str, bias_key: str):
        out = conv(conv_name, w)
        if bn_key in p:
            out.update(bn(bn_name, p[bn_key]))
        else:
            out[f"{conv_name}.bias"] = _f32(p[bias_key])
        return out

    out = conv_bn("conv1", "bn1", params["stem"]["conv"], params["stem"], "bn", "bias")
    for layer in sorted(k for k in params if k.startswith("layer")):
        for b, blk in enumerate(params[layer]):
            p = f"{layer}.{b}"
            for i in (1, 2, 3):
                out.update(conv_bn(f"{p}.conv{i}", f"{p}.bn{i}", blk[f"conv{i}"], blk, f"bn{i}", f"bias{i}"))
            if "downsample" in blk:
                d = blk["downsample"]
                out.update(conv_bn(f"{p}.downsample.0", f"{p}.downsample.1", d["conv"], d, "bn", "bias"))
    return out


def check_shapes(sd: Mapping[str, torch.Tensor], c: ModelConfig) -> None:
    got_h, got_in = sd["trunk.fc1.weight"].shape
    if got_in != c.in_dim or got_h != c.hidden_dim:
        raise ValueError(f"trunk fc1 shape {(got_in, got_h)} != config {(c.in_dim, c.hidden_dim)}")
    got_cls = sd["cls_head.weight"].shape[0]
    if got_cls != c.n_classes:
        raise ValueError(f"checkpoint has {got_cls} classes, config expects {c.n_classes}")
