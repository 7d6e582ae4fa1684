"""Carry weights into the port.

Two sources, each turned into a port ``state_dict``:

  * the JAX package's Flax variable trees (numpy leaves):
    :func:`unet_from_jax`, :func:`dt_from_jax`, :func:`arniqa_from_jax`.
    Conv kernels go HWIO -> OIHW, Dense kernels are transposed, and the
    state encoder's dense kernel is permuted from the NHWC flatten of the
    JAX model to the NCHW flatten of the port.
  * the reference's published PyTorch checkpoints (``unet-nm.pt``,
    ``model_experiment_{1,2}.pt``) and the ARNIQA hub checkpoint:
    :func:`unet_from_reference`, :func:`dt_from_reference`,
    :func:`arniqa_from_hub`. Only key names change. :func:`unet_to_reference`
    and :func:`dt_to_reference` write a port model back in the reference's
    layout.

Every converter is strict: a missing or unconsumed key raises.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.decision_transformer import state_conv_hw


def _t(a) -> torch.Tensor:
    """A float32 tensor copy of a numpy array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone()
    return torch.tensor(np.array(a, dtype=np.float32))


def _conv(k) -> torch.Tensor:
    """Flax HWIO conv kernel -> torch OIHW."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense(k) -> torch.Tensor:
    """Flax (in, out) dense kernel -> torch (out, in)."""
    return _t(np.transpose(np.asarray(k)))


def _check_keys(got: Mapping[str, Any], want: Mapping[str, Any],
                what: str) -> None:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what}: missing keys {missing}, "
                         f"unexpected keys {extra}")


def _strip(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop the prefixes torch.compile and DDP wrappers add."""
    return {k.removeprefix("module.").removeprefix("_orig_mod."): v
            for k, v in sd.items()}


# --- U-Net ---------------------------------------------------------------

def unet_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UNetDenoiser`` params ``{'net': {block: {convI: ...}}}`` ->
    port ``UNetDenoiser`` state dict."""
    sd = {}
    for block, convs in params["net"].items():
        if block == "outc":
            sd["net.outc.weight"] = _conv(convs["kernel"])
            sd["net.outc.bias"] = _t(convs["bias"])
            continue
        for conv, leaf in convs.items():
            sd[f"net.{block}.{conv}.weight"] = _conv(leaf["kernel"])
            sd[f"net.{block}.{conv}.bias"] = _t(leaf["bias"])
    return sd


_UNET_REF = re.compile(
    r"(inc|down\d|up\d)\.(?:conv|mpconv\.1)\.conv-(\d)\.conv2d\.(weight|bias)")


def unet_from_reference(state_dict: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """Reference U-Net ``state_dict`` (``inc.conv.conv-{i}.conv2d.*``,
    ``down{k}.mpconv.1.conv-{i}.conv2d.*``, ``up{k}.conv.conv-{i}.conv2d.*``,
    ``outc.conv.*``; an optional ``net.`` prefix) -> port state dict."""
    sd = {}
    for key, v in _strip(state_dict).items():
        key = key.removeprefix("net.")
        if key in ("outc.conv.weight", "outc.conv.bias"):
            sd["net.outc." + key.rsplit(".", 1)[1]] = _t(v)
            continue
        m = _UNET_REF.fullmatch(key)
        if m is None:
            raise ValueError(f"unrecognized U-Net checkpoint key: {key}")
        sd[f"net.{m.group(1)}.conv{m.group(2)}.{m.group(3)}"] = _t(v)
    return sd


def unet_to_reference(state_dict: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """Port ``UNetDenoiser`` state dict -> the reference U-Net's
    ``state_dict`` layout (the inverse of :func:`unet_from_reference`; the
    keys of the JAX package's ``export_unet_state_dict``). Values are
    float32 CPU copies."""
    sd = {}
    for key, v in _strip(state_dict).items():
        if key in ("net.outc.weight", "net.outc.bias"):
            sd["outc.conv." + key.rsplit(".", 1)[1]] = _t(v).cpu()
            continue
        m = re.fullmatch(r"net\.(inc|down\d|up\d)\.conv(\d)\.(weight|bias)",
                         key)
        if m is None:
            raise ValueError(f"unrecognized port U-Net key: {key}")
        block, i, leaf = m.groups()
        if block == "inc":
            holder = "inc.conv"
        elif block.startswith("down"):
            holder = f"{block}.mpconv.1"
        else:
            holder = f"{block}.conv"
        sd[f"{holder}.conv-{i}.conv2d.{leaf}"] = _t(v).cpu()
    return sd


# --- Decision Transformer ------------------------------------------------

def dt_from_jax(params: Mapping[str, Any], cfg: ModelConfig
                ) -> Dict[str, torch.Tensor]:
    """JAX ``DecisionTransformer`` params -> port state dict."""
    sd = {
        "time_embed.weight": _t(params["time_embed"]["embedding"]),
        "task_embed.weight": _t(params["task_embed"]["embedding"]),
        "layer_n.weight": _t(params["layer_n"]["scale"]),
        "layer_n.bias": _t(params["layer_n"]["bias"]),
    }

    def dense(name, leaf):
        sd[name + ".weight"] = _dense(leaf["kernel"])
        sd[name + ".bias"] = _t(leaf["bias"])

    for name in ("embed_return", "embed_action", "predict_action",
                 "predict_rtg"):
        dense(name, params[name])
    enc = params["state_encoder"]
    for i in range(3):
        sd[f"state_encoder.conv{i}.weight"] = _conv(enc[f"conv{i}"]["kernel"])
        sd[f"state_encoder.conv{i}.bias"] = _t(enc[f"conv{i}"]["bias"])
    # JAX flattens the (H, W, C) activation, the port the (C, H, W) one.
    hw, ch = state_conv_hw(cfg.image_size), 16
    k = np.asarray(enc["dense"]["kernel"])
    k = k.reshape(hw, hw, ch, -1).transpose(2, 0, 1, 3).reshape(
        ch * hw * hw, -1)
    sd["state_encoder.dense.weight"] = _dense(k)
    sd["state_encoder.dense.bias"] = _t(enc["dense"]["bias"])
    for i in range(cfg.n_blocks):
        blk, p = params[f"block{i}"], f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            sd[p + ln + ".weight"] = _t(blk[ln]["scale"])
            sd[p + ln + ".bias"] = _t(blk[ln]["bias"])
        dense(p + "attn.qkv_proj", blk["attn"]["qkv_proj"])
        dense(p + "attn.o_proj", blk["attn"]["o_proj"])
        dense(p + "fc", blk["fc"])
        dense(p + "fc_proj", blk["fc_proj"])
    return sd


_DT_REF = [
    (r"embed_(action|return)\.0\.(.*)", r"embed_\1.\2"),
    (r"state_encoder\.0\.(.*)", r"state_encoder.conv0.\1"),
    (r"state_encoder\.2\.(.*)", r"state_encoder.conv1.\1"),
    (r"state_encoder\.4\.(.*)", r"state_encoder.conv2.\1"),
    (r"state_encoder\.7\.(.*)", r"state_encoder.dense.\1"),
    (r"transformer\.(\d+)\.(ln1|ln2)\.(.*)", r"blocks.\1.\2.\3"),
    (r"transformer\.(\d+)\.c_att\.(qkv_proj|o_proj)\.(.*)",
     r"blocks.\1.attn.\2.\3"),
    (r"transformer\.(\d+)\.mlp\.(fc|fc_proj)\.(.*)", r"blocks.\1.\2.\3"),
    (r"predict_action\.0\.(.*)", r"predict_action.\1"),
    (r"(time_embed|task_embed|layer_n|predict_rtg)\.(.*)", r"\1.\2"),
]


def dt_from_reference(state_dict: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """Reference DT ``state_dict`` (``model_experiment_{1,2}.pt`` layout) ->
    port state dict. The causal-mask ``masking`` buffers are dropped."""
    sd = {}
    for key, v in _strip(state_dict).items():
        if re.fullmatch(r"transformer\.\d+\.c_att\.masking", key):
            continue
        for pat, repl in _DT_REF:
            if re.fullmatch(pat, key):
                sd[re.sub(pat, repl, key)] = _t(v)
                break
        else:
            raise ValueError(f"unrecognized DT checkpoint key: {key}")
    return sd


# Port names -> reference names: the inverse of _DT_REF.
_DT_TO_REF = [
    (r"embed_(action|return)\.(.*)", r"embed_\1.0.\2"),
    (r"state_encoder\.conv0\.(.*)", r"state_encoder.0.\1"),
    (r"state_encoder\.conv1\.(.*)", r"state_encoder.2.\1"),
    (r"state_encoder\.conv2\.(.*)", r"state_encoder.4.\1"),
    (r"state_encoder\.dense\.(.*)", r"state_encoder.7.\1"),
    (r"blocks\.(\d+)\.(ln1|ln2)\.(.*)", r"transformer.\1.\2.\3"),
    (r"blocks\.(\d+)\.attn\.(qkv_proj|o_proj)\.(.*)",
     r"transformer.\1.c_att.\2.\3"),
    (r"blocks\.(\d+)\.(fc|fc_proj)\.(.*)", r"transformer.\1.mlp.\2.\3"),
    (r"predict_action\.(.*)", r"predict_action.0.\1"),
    (r"(time_embed|task_embed|layer_n|predict_rtg)\.(.*)", r"\1.\2"),
]


def dt_to_reference(state_dict: Mapping[str, Any],
                    block_size: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
    """Port DT state dict -> the reference's ``state_dict`` layout (the
    inverse of :func:`dt_from_reference`). With ``block_size``, also the
    causal-mask ``masking`` buffer of each attention block,
    ``tril(ones(block_size, block_size)).view(1, 1, B, B)``, so that the
    reference model loads it strictly (the JAX package's
    ``export_dt_state_dict`` does the same). Values are float32 CPU
    copies."""
    sd = {}
    for key, v in state_dict.items():
        for pat, repl in _DT_TO_REF:
            if re.fullmatch(pat, key):
                sd[re.sub(pat, repl, key)] = _t(v).cpu()
                break
        else:
            raise ValueError(f"unrecognized port DT key: {key}")
    if block_size is not None:
        mask = torch.ones(block_size, block_size).tril().view(
            1, 1, block_size, block_size)
        for i in sorted({int(m.group(1)) for k in state_dict
                         if (m := re.match(r"blocks\.(\d+)\.", k))}):
            sd[f"transformer.{i}.c_att.masking"] = mask.clone()
    return sd


# --- ARNIQA ----------------------------------------------------------------

def arniqa_from_jax(variables: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """JAX ``ARNIQA`` variables ``{'params', 'batch_stats'}`` -> port
    ``ARNIQA`` state dict (torchvision names under ``encoder.model.``)."""
    params, stats = variables["params"], variables["batch_stats"]
    enc_p, enc_s = params["encoder"], stats["encoder"]
    pre = "encoder.model."
    sd = {}

    def conv(dst, leaf):
        sd[pre + dst + ".weight"] = _conv(leaf["kernel"])

    def bn(dst, p, s):
        sd[pre + dst + ".weight"] = _t(p["scale"])
        sd[pre + dst + ".bias"] = _t(p["bias"])
        sd[pre + dst + ".running_mean"] = _t(s["mean"])
        sd[pre + dst + ".running_var"] = _t(s["var"])
        sd[pre + dst + ".num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long)

    conv("conv1", enc_p["conv1"])
    bn("bn1", enc_p["bn1"], enc_s["bn1"])
    for name, bp in enc_p.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m is None:
            continue
        dst, bs = f"layer{m.group(1)}.{m.group(2)}.", enc_s[name]
        for i in (1, 2, 3):
            conv(dst + f"conv{i}", bp[f"conv{i}"])
            bn(dst + f"bn{i}", bp[f"bn{i}"], bs[f"bn{i}"])
        if "ds_conv" in bp:
            conv(dst + "downsample.0", bp["ds_conv"])
            bn(dst + "downsample.1", bp["ds_bn"], bs["ds_bn"])
    sd["regressor.weight"] = _dense(params["regressor"]["kernel"])
    sd["regressor.bias"] = _t(params["regressor"]["bias"])
    return sd


def arniqa_from_hub(state_dict: Mapping[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """ARNIQA hub ``state_dict`` (``encoder.model.*`` torchvision ResNet-50,
    ``regressor.*``) -> port state dict: the unused classification head
    ``encoder.model.fc.*`` is dropped, BatchNorm's ``num_batches_tracked``
    counters are kept as integers, everything else becomes float32."""
    sd = {}
    for key, v in _strip(state_dict).items():
        if key.startswith("encoder.model.fc."):
            continue
        sd[key] = torch.as_tensor(v).detach().clone() \
            if key.endswith("num_batches_tracked") else _t(v)
    return sd


def load_strict(model: torch.nn.Module, sd: Mapping[str, torch.Tensor],
                what: str) -> torch.nn.Module:
    """``model.load_state_dict(sd)`` with the converters' error message."""
    _check_keys(sd, model.state_dict(), what)
    model.load_state_dict(sd)
    return model
