"""Reference PyTorch checkpoints into the port (the port's copy of
``adamml_tpu/ckpt/torch_convert.py``).

Lets reference users carry their checkpoints over: torchvision ResNets
(reference models/resnet.py:244-259 loads these), torchvision MobileNetV2
(reference models/sound_mobilenet_v2.py:177-198), the d-li14 160x160
MobileNetV2 policy trunk (reference models/policy_net.py:193-203), and torch
LSTMCell weights (reference models/policy_net.py:278).

The output is the flax tree path the JAX package's converter writes --
(params, batch_stats) as nested dicts of numpy arrays, conv kernels
(kh, kw, I, O), Dense kernels (I, O) -- which is also the port's module
naming (``ckpt/flax_convert.py``), so ``flax_convert.flax_state_dict`` turns
it into the port's state-dict names and torch layouts. The transposes are
exact, so a reference tensor arrives in the port bit for bit.

Input is a plain {key: numpy array} state dict; the 'module.' DDP prefix is
stripped here, mirroring reference models/joint_resnet_mobilenetv2.py:147.

Also provides channel inflation for non-RGB inputs: the first conv's RGB
kernels are averaged and broadcast to the target channel count (reference
models/resnet.py:19-33, sound_mobilenet_v2.py:188-196).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

Array = np.ndarray
StateDict = Mapping[str, Array]


def strip_module_prefix(sd: StateDict) -> Dict[str, Array]:
    return {k[len("module."):] if k.startswith("module.") else k: np.asarray(v)
            for k, v in sd.items()}


def _conv(w: Array) -> Array:
    """torch conv weight (O, I, kh, kw) -> flax kernel (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w: Array) -> Array:
    """torch linear weight (O, I) -> flax kernel (I, O)."""
    return np.transpose(w, (1, 0))


def inflate_first_conv(w: Array, input_channels: int) -> Array:
    """Average RGB kernels and broadcast to `input_channels`
    (reference models/resnet.py:19-33). torch layout (O, 3, kh, kw)."""
    mean = w.mean(axis=1, keepdims=True)
    return np.broadcast_to(
        mean, (w.shape[0], input_channels, w.shape[2], w.shape[3])).copy()


def _bn(sd: StateDict, prefix: str) -> Tuple[dict, dict]:
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


_RESNET_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                  101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def convert_resnet_state_dict(sd: StateDict, depth: int,
                              input_channels: int = 3,
                              include_head: bool = True
                              ) -> Tuple[dict, dict]:
    """torchvision-layout ResNet state dict -> (params, batch_stats) in the
    flax tree path of ResNetTSN (models/resnet_tsn.py)."""
    sd = strip_module_prefix(sd)
    params: dict = {}
    stats: dict = {}
    w = np.asarray(sd["conv1.weight"])
    if input_channels != 3 and w.shape[1] == 3:
        w = inflate_first_conv(w, input_channels)
    params["conv1"] = {"kernel": _conv(w)}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")

    kind = "basic" if depth < 50 else "bottleneck"
    convs_per_block = 2 if kind == "basic" else 3
    for stage, nblocks in enumerate(_RESNET_BLOCKS[depth]):
        for b in range(nblocks):
            t_pre = f"layer{stage + 1}.{b}"
            name = f"layer{stage + 1}_{b}"
            bp: dict = {}
            bs: dict = {}
            for ci in range(1, convs_per_block + 1):
                conv = {"kernel": _conv(np.asarray(sd[f"{t_pre}.conv{ci}.weight"]))}
                bnp, bns = _bn(sd, f"{t_pre}.bn{ci}")
                bp[f"cb{ci}"] = {"conv": conv, "bn": bnp}
                bs[f"cb{ci}"] = {"bn": bns}
            if f"{t_pre}.downsample.0.weight" in sd:
                conv = {"kernel": _conv(np.asarray(sd[f"{t_pre}.downsample.0.weight"]))}
                bnp, bns = _bn(sd, f"{t_pre}.downsample.1")
                bp["downsample"] = {"conv": conv, "bn": bnp}
                bs["downsample"] = {"bn": bns}
            params[name] = bp
            stats[name] = bs

    if include_head and "fc.weight" in sd:
        params["fc"] = {"kernel": _dense(np.asarray(sd["fc.weight"])),
                        "bias": np.asarray(sd["fc.bias"])}
    return params, stats


def _convbnrelu(sd: StateDict, conv_key: str, bn_key: str) -> Tuple[dict, dict]:
    conv = {"kernel": _conv(np.asarray(sd[conv_key]))}
    bnp, bns = _bn(sd, bn_key)
    return ({"conv": conv, "bn": bnp}, {"bn": bns})


# MobileNetV2 inverted-residual block counts per stage (both references)
_MNV2_STAGE_N = (1, 2, 3, 4, 3, 3, 1)
_MNV2_EXPAND = (1, 6, 6, 6, 6, 6, 6)


def convert_mobilenet_v2_state_dict(sd: StateDict, *, layout: str,
                                    input_channels: int = 3,
                                    include_head: bool = True
                                    ) -> Tuple[dict, dict]:
    """MobileNetV2 state dict -> (params, batch_stats) in the flax tree path
    of MobileNetV2 (models/mobilenet_v2.py).

    layout='torchvision': reference models/sound_mobilenet_v2.py key scheme
      features.i.conv.{0.{0,1}, 1.{0,1}, 2, 3} / features.18 / classifier.1
    layout='d-li14': reference models/policy_net.py key scheme
      features.i.conv.{0,1,3,4,6,7} (ReLU6 inline) / conv.{0,1} / classifier
    """
    sd = strip_module_prefix(sd)
    params: dict = {}
    stats: dict = {}

    w0 = np.asarray(sd["features.0.0.weight"])
    if input_channels != 3 and w0.shape[1] == 3:
        w0 = inflate_first_conv(w0, input_channels)
    p, s = _convbnrelu({**sd, "features.0.0.weight": w0},
                       "features.0.0.weight", "features.0.1")
    params["features_0"], stats["features_0"] = p, s

    idx = 1
    for stage, nblocks in enumerate(_MNV2_STAGE_N):
        expand = _MNV2_EXPAND[stage]
        for _ in range(nblocks):
            pre = f"features.{idx}.conv"
            bp: dict = {}
            bs: dict = {}
            if layout == "torchvision":
                if expand != 1:
                    bp["pw"], bs["pw"] = _convbnrelu(sd, f"{pre}.0.0.weight",
                                                     f"{pre}.0.1")
                    dw_i, pwl_i, bnl_i = "1", "2", "3"
                else:
                    dw_i, pwl_i, bnl_i = "0", "1", "2"
                bp["dw"], bs["dw"] = _convbnrelu(sd, f"{pre}.{dw_i}.0.weight",
                                                 f"{pre}.{dw_i}.1")
                bp["pw_linear"] = {"kernel": _conv(np.asarray(sd[f"{pre}.{pwl_i}.weight"]))}
                bnp, bns = _bn(sd, f"{pre}.{bnl_i}")
            elif layout == "d-li14":
                if expand != 1:
                    bp["pw"], bs["pw"] = _convbnrelu(sd, f"{pre}.0.weight",
                                                     f"{pre}.1")
                    dw_c, dw_b, pwl, bnl = "3", "4", "6", "7"
                else:
                    dw_c, dw_b, pwl, bnl = "0", "1", "3", "4"
                bp["dw"], bs["dw"] = _convbnrelu(sd, f"{pre}.{dw_c}.weight",
                                                 f"{pre}.{dw_b}")
                bp["pw_linear"] = {"kernel": _conv(np.asarray(sd[f"{pre}.{pwl}.weight"]))}
                bnp, bns = _bn(sd, f"{pre}.{bnl}")
            else:
                raise ValueError(f"unknown layout {layout!r}")
            bp["bn_linear"], bs["bn_linear"] = bnp, bns
            params[f"features_{idx}"] = bp
            stats[f"features_{idx}"] = bs
            idx += 1

    if layout == "torchvision":
        p, s = _convbnrelu(sd, "features.18.0.weight", "features.18.1")
        head_w, head_b = "classifier.1.weight", "classifier.1.bias"
    else:
        p, s = _convbnrelu(sd, "conv.0.weight", "conv.1")
        head_w, head_b = "classifier.weight", "classifier.bias"
    params["conv_last"], stats["conv_last"] = p, s

    if include_head and head_w in sd:
        params["classifier"] = {"kernel": _dense(np.asarray(sd[head_w])),
                                "bias": np.asarray(sd[head_b])}
    return params, stats


def convert_lstm_cell(sd: StateDict, prefix: str = "lstm") -> dict:
    """torch LSTMCell params -> the decision cell's ih / hh Dense params
    (policy_net.lstm). Gate order (i, f, g, o) is preserved on both
    sides."""
    sd = strip_module_prefix(sd)
    return {
        "ih": {"kernel": _dense(np.asarray(sd[f"{prefix}.weight_ih"])),
               "bias": np.asarray(sd[f"{prefix}.bias_ih"])},
        "hh": {"kernel": _dense(np.asarray(sd[f"{prefix}.weight_hh"])),
               "bias": np.asarray(sd[f"{prefix}.bias_hh"])},
    }
