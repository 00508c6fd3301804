"""Weight bridge: the JAX package's flax variables → this port's state_dict.

The inverse of the layout rules of ``diner_tpu/utils/torch_convert.py``.
Input is ``{"params": tree, "batch_stats": tree}`` as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, variables)``): a PixelNeRF's
variables, or ``{"params": init_vgg19_params(seed)}`` for the VGG19 of the
perceptual loss (``conv_{idx}/kernel|bias``). The port's modules carry the
flax names, so a path maps to a dotted key 1:1:

  conv kernel (kH, kW, I, O) → ``weight`` (O, I, kH, kW)
  dense kernel (I, O)        → ``weight`` (O, I)
  ``bias`` → ``bias``; BN ``scale`` → ``weight``
  batch_stats ``mean`` / ``var`` → ``running_mean`` / ``running_var``

``novel_flax_to_state_dict`` and ``regressor_flax_to_state_dict`` do the
same for NOVEL / NOVEL_PE (the gen-latent plane and the deformation layer
besides) and for the dense keypoint regressor;
``keypointnerf_flax_to_state_dict`` for KeypointNeRF (GroupNorm scales,
WNLinear's ``v`` (in, out), ``g`` and ``bias`` as flax keeps them, and
the colour head's scalar ``ani_al``).

``lpips_to_state_dict`` bridges the LPIPS parameters of
``diner_tpu/evaluation/metrics.py`` (``{"vgg": conv tree, "lins": (C,)
weights per tap}``, e.g. its ``init_lpips_proxy``) to the port's
``evaluation/metrics.py:LPIPSVGG``.

Two more bridges read torch state dicts of the reference's world:

- ``convert_resnet``, ``convert_vgg19_features`` and
  ``load_lpips_weights`` turn torchvision / lpips ``.pth`` state dicts
  into the flax-layout trees of the pretrained ``.npz`` files (copies of
  ``diner_tpu/utils/torch_convert.py:38,126`` and
  ``diner_tpu/evaluation/metrics.py:160``, numpy only);
- ``reference_to_state_dict`` maps a reference PixelNeRF state dict
  (``encoder.*`` and ``mlp_fine.*``, e.g. from a Lightning ``.ckpt``)
  straight onto the port's ``PixelNeRF.state_dict()``: what
  ``convert_pixelnerf`` followed by ``flax_to_state_dict`` computes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 2:
        return w.T
    raise ValueError(f"unsupported kernel rank {w.ndim}")


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` flax tree → ``{dotted key: tensor}``."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        for path, value in _walk(variables.get(collection, {})):
            if path[-1] not in leaves:
                raise KeyError(f"unknown {collection} leaf {'/'.join(path)}")
            if path[-1] == "kernel":
                value = _kernel(value)
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            sd[key] = torch.tensor(value, dtype=torch.float32)
    return sd


def novel_flax_to_state_dict(variables: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """A NovelPixelNeRF's flax variables → the port's state_dict: what
    :func:`flax_to_state_dict` maps, plus the gen-latent plane (a bare
    (H, W, C) parameter, channels-last in both packages) and, for NOVEL_PE,
    ``deformation_layer`` (a dense layer)."""
    params = dict(variables["params"])
    plane = params.pop("gen_latent")
    sd = flax_to_state_dict({**variables, "params": params})
    sd["gen_latent"] = torch.tensor(np.asarray(plane), dtype=torch.float32)
    return sd


def keypointnerf_flax_to_state_dict(variables: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """A KeypointNeRF's flax variables → the port's state_dict: what
    :func:`flax_to_state_dict` maps (conv kernels HWIO → OIHW, dense
    kernels, GroupNorm scale / bias), plus the leaves the port keeps in
    flax's layout, WNLinear's ``v`` (in, out) and ``g``, and ``ani_al``."""
    sd: Dict[str, torch.Tensor] = {}

    def split(tree, prefix=()):
        rest = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                rest[k] = split(v, prefix + (k,))
            elif k in ("v", "g", "ani_al"):
                sd[".".join(prefix + (k,))] = torch.tensor(
                    np.asarray(v), dtype=torch.float32)
            else:
                rest[k] = v
        return rest

    sd.update(flax_to_state_dict({"params": split(variables["params"])}))
    return sd


def regressor_flax_to_state_dict(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """A DenseRegressor's flax variables (``backbone`` ResNet, ``head``
    dense layer, BN statistics) → the port's ``DenseRegressor``
    state_dict."""
    unknown = sorted(set(variables["params"]) - {"backbone", "head"})
    if unknown:
        raise KeyError(f"unknown regressor parameters {unknown}")
    return flax_to_state_dict(variables)


def lpips_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LPIPS params (numpy arrays) → a full ``LPIPSVGG`` state_dict."""
    from diner_tpu_torch.evaluation.metrics import LPIPSVGG
    sd = LPIPSVGG().state_dict()  # the input normalisation buffers
    sd.update(flax_to_state_dict({"params": params["vgg"]}))
    for i, w in enumerate(params["lins"]):
        sd[f"lin_{i}"] = torch.tensor(np.asarray(w).reshape(-1),
                                      dtype=torch.float32)
    return sd


# ------------------------------------------- torchvision / lpips → flax trees

def _conv(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (O, I, kH, kW) → flax (kH, kW, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value)


def convert_resnet(sd: Mapping[str, np.ndarray], num_layers: int = 4,
                   backbone_blocks=(3, 4, 6, 3)):
    """torchvision resnet{18,34} state dict (numpy) → the encoder's flax
    ``{"params", "batch_stats"}``, for the stages the truncated encoder
    uses (``num_layers`` pyramid levels)."""
    params: Dict = {}
    stats: Dict = {}

    def bn(src_prefix, dst_name):
        _set(params, dst_name + ("scale",), sd[src_prefix + ".weight"])
        _set(params, dst_name + ("bias",), sd[src_prefix + ".bias"])
        _set(stats, dst_name + ("mean",), sd[src_prefix + ".running_mean"])
        _set(stats, dst_name + ("var",), sd[src_prefix + ".running_var"])

    _set(params, ("conv1", "kernel"), _conv(sd["conv1.weight"]))
    bn("bn1", ("bn1",))
    for stage in range(4):
        if num_layers <= stage + 1:
            break
        for blk in range(backbone_blocks[stage]):
            src = f"layer{stage + 1}.{blk}"
            dst = f"layer{stage + 1}_{blk}"
            _set(params, (dst, "conv1", "kernel"),
                 _conv(sd[src + ".conv1.weight"]))
            _set(params, (dst, "conv2", "kernel"),
                 _conv(sd[src + ".conv2.weight"]))
            bn(src + ".bn1", (dst, "bn1"))
            bn(src + ".bn2", (dst, "bn2"))
            if src + ".downsample.0.weight" in sd:
                _set(params, (dst, "downsample_conv", "kernel"),
                     _conv(sd[src + ".downsample.0.weight"]))
                bn(src + ".downsample.1", (dst, "downsample_bn"))
    return {"params": params, "batch_stats": stats}


def convert_vgg19_features(sd: Mapping[str, np.ndarray]):
    """torchvision vgg ``features.*`` conv weights (numpy) → ``{"params":
    {"conv_{torch index}": {"kernel", "bias"}}}``. The full model's
    ``classifier.*`` entries are skipped (the JAX package's converter reads
    every key as a ``features`` one and stops at them)."""
    params: Dict = {}
    for k, v in sd.items():
        if not k.startswith("features."):
            continue
        idx, kind = k.removeprefix("features.").split(".")
        if kind == "weight":
            _set(params, (f"conv_{idx}", "kernel"), _conv(v))
        elif kind == "bias":
            _set(params, (f"conv_{idx}", "bias"), v)
    return {"params": params}


def load_lpips_weights(vgg16_state_dict, lpips_lin_state_dict):
    """LPIPS params from torchvision vgg16 ``features.*`` and the lpips
    package's ``lins.N.model.1.weight`` tensors (numpy arrays)."""
    vgg = convert_vgg19_features(vgg16_state_dict)["params"]
    lins = tuple(
        np.asarray(lpips_lin_state_dict[f"lins.{i}.model.1.weight"])
        .reshape(-1).astype(np.float32)
        for i in range(5))
    return {"vgg": vgg, "lins": lins}


# --------------------------------------- reference PixelNeRF → port modules

def reference_state_dict(blob) -> Dict[str, np.ndarray]:
    """A Lightning checkpoint (``{"state_dict": …}``) or a bare state dict
    → ``{key: numpy array}`` of its tensors (``convert_checkpoint.py:25-33``)."""
    sd = blob.get("state_dict", blob) if isinstance(blob, Mapping) else blob
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in sd.items() if hasattr(v, "shape")}


# reference key (after ``encoder.model.`` / ``mlp_fine.``) → port key
_ENCODER_RULES = (
    (re.compile(r"(conv1|bn1)\.(.+)"), r"\1.\2"),
    (re.compile(r"layer(\d)\.(\d+)\.downsample\.0\.(.+)"),
     r"layer\1_\2.downsample_conv.\3"),
    (re.compile(r"layer(\d)\.(\d+)\.downsample\.1\.(.+)"),
     r"layer\1_\2.downsample_bn.\3"),
    (re.compile(r"layer(\d)\.(\d+)\.(conv1|conv2|bn1|bn2)\.(.+)"),
     r"layer\1_\2.\3.\4"),
)
_MLP_RULES = (
    (re.compile(r"(lin_in|lin_out)\.(.+)"), r"\1.\2"),
    (re.compile(r"lin_z\.(\d+)\.(.+)"), r"lin_z_\1.\2"),
    (re.compile(r"blocks\.(\d+)\.(fc_0|fc_1|shortcut)\.(.+)"),
     r"block_\1.\2.\3"),
)


def _translate(rules, key):
    for pattern, repl in rules:
        if pattern.fullmatch(key):
            return pattern.sub(repl, key)
    return None


def reference_to_state_dict(sd: Mapping, template: Mapping,
                            prefix: str = "nerf.") -> Dict[str, torch.Tensor]:
    """A reference PixelNeRF state dict → the port's ``PixelNeRF``
    state dict, keyed and shaped as ``template`` (the model's own
    ``state_dict()``).

    ``sd`` is a Lightning checkpoint (``{"state_dict": …}``) or a bare state
    dict; keys are read under ``prefix`` (``nerf.`` in the reference's
    Lightning DINER, ``""`` for a bare PixelNeRF). Of those, ``encoder.model.*``
    (the torchvision ResNet, conv1 already widened for the PE ring) and
    ``mlp_fine.*`` (ResnetFC) are mapped; other PixelNeRF entries (the
    positional encodings' buffers) hold no weights. Dropped too, as
    ``convert_pixelnerf`` drops them: ``num_batches_tracked``, torchvision's
    ``fc`` head and the stages past the truncated encoder. Any other key,
    a model key the checkpoint lacks, or a shape mismatch raises, naming
    the key. Tensors come out f32 on the CPU.
    """
    sd = reference_state_dict(sd)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not sd:
        raise KeyError(f"no keys under prefix {prefix!r}")
    stages = {m.group(1) for k in template
              if (m := re.match(r"encoder\.resnet\.layer(\d)_", k))}
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("encoder.model."):
            sub = key[len("encoder.model."):]
            stage = re.match(r"layer(\d)\.", sub)
            if sub.startswith("fc.") or (stage and stage.group(1)
                                         not in stages):
                continue  # not part of the truncated encoder
            name = _translate(_ENCODER_RULES, sub)
            name = name and "encoder.resnet." + name
        elif key.startswith("mlp_fine."):
            name = _translate(_MLP_RULES, key[len("mlp_fine."):])
            name = name and "mlp." + name
        else:
            continue
        if name is None or name not in template:
            raise KeyError(f"checkpoint key {prefix}{key} has no place in "
                           "the model (architecture/config mismatch?)")
        if tuple(template[name].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at {prefix}{key}: model "
                f"{tuple(template[name].shape)} vs ckpt {tuple(value.shape)}")
        out[name] = torch.tensor(value, dtype=torch.float32)
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"checkpoint lacks {missing[0]} "
                       f"({len(missing)} model keys in all)")
    return out


# ----------------------------------------------------------- TransMVSNet

def _dcn_weight(k: np.ndarray) -> np.ndarray:
    """JAX DCN kernel (9·C, O), tap-major → torch (O, C, 3, 3)."""
    C = k.shape[0] // 9
    return k.reshape(3, 3, C, -1).transpose(3, 2, 0, 1)


def _conv3d_weight(k: np.ndarray) -> np.ndarray:
    """flax (kD, kH, kW, I, O) → torch Conv3d (O, I, kD, kH, kW)."""
    return np.transpose(k, (4, 3, 0, 1, 2))


def _deconv3d_weight(k: np.ndarray) -> np.ndarray:
    """The JAX package's interior-pad VALID conv kernel (kD, kH, kW, I, O),
    spatially flipped → torch ConvTranspose3d (I, O, kD, kH, kW)."""
    return np.transpose(k, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]


def transmvsnet_flax_to_state_dict(variables: Mapping, num_stage: int = 3,
                                   n_fmt_layers: int = 8
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's TransMVSNet ``{"params", "batch_stats"}`` (numpy)
    → the port's ``TransMVSNet.state_dict()``: the inverse of
    ``diner_tpu/utils/torch_convert.py:convert_transmvsnet``, plus the
    SuperGlue PE's MLP where the model has one. BN ``num_batches_tracked``
    is 0."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return np.asarray(tree)

    def put(key, value):
        sd[key] = torch.tensor(np.ascontiguousarray(value),
                               dtype=torch.float32)

    def bn(src, dst):
        put(dst + ".weight", get(params, src + ("scale",)))
        put(dst + ".bias", get(params, src + ("bias",)))
        put(dst + ".running_mean", get(stats, src + ("mean",)))
        put(dst + ".running_var", get(stats, src + ("var",)))
        sd[dst + ".num_batches_tracked"] = torch.tensor(0)

    def conv_bn(src, dst, kernel=_kernel):
        put(dst + ".conv.weight", kernel(get(params, src + ("conv", "kernel"))))
        bn(src + ("bn",), dst + ".bn")

    def dense(src, dst, kernel=_kernel):
        put(dst + ".weight", kernel(get(params, src + ("kernel",))))
        put(dst + ".bias", get(params, src + ("bias",)))

    F = ("feature",)
    for i, n in ((0, 2), (1, 3), (2, 3)):
        for j in range(n):
            conv_bn(F + (f"conv{i}_{j}",), f"feature.conv{i}.{j}")
    for n in (1, 2, 3):
        conv_bn(F + (f"out{n}_conv",), f"feature.out{n}.0")
        for slot, idx in ((0, 1), (1, 4), (2, 7)):
            src = F + (f"out{n}_dcn{slot}",)
            dense(src, f"feature.out{n}.{idx}", _dcn_weight)
            dense(src + ("conv_offset_mask",),
                  f"feature.out{n}.{idx}.conv_offset_mask")
        for slot, idx in ((0, 2), (1, 5)):
            bn(F + (f"out{n}_bn{slot}",), f"feature.out{n}.{idx}")
    for n in (1, 2):
        dense(F + (f"inner{n}",), f"feature.inner{n}")

    P = ("FMT_with_pathway",)
    for i in range(n_fmt_layers):
        src = P + ("FMT", f"layer_{i}")
        dst = f"FMT_with_pathway.FMT.layers.{i}"
        for proj in ("query", "key", "value", "out"):
            dense(src + ("attention", f"{proj}_projection"),
                  f"{dst}.attention.{proj}_projection")
        for lin in ("linear1", "linear2"):
            dense(src + (lin,), f"{dst}.{lin}")
        for nrm in ("norm1", "norm2"):
            put(f"{dst}.{nrm}.weight", get(params, src + (nrm, "scale")))
            put(f"{dst}.{nrm}.bias", get(params, src + (nrm, "bias")))
    pe = params["FMT_with_pathway"]["FMT"].get("pos_encoding")
    if pe is not None:  # SuperGlue PE: Dense ↔ Conv1d(k=1), kenc.encoder.j
        def conv1d(w):
            return w.T[:, :, None]
        src = P + ("FMT", "pos_encoding")
        dst = "FMT_with_pathway.FMT.pos_encoding.kenc.encoder"
        for name, j in (("mlp_0", 0), ("mlp_1", 3), ("mlp_out", 6)):
            dense(src + (name,), f"{dst}.{j}", conv1d)
        for name, j in (("bn_0", 1), ("bn_1", 4)):
            bn(src + (name,), f"{dst}.{j}")
    for n in (1, 2):
        for m in ("dim_reduction", "smooth"):
            put(f"FMT_with_pathway.{m}_{n}.weight",
                _kernel(get(params, P + (f"{m}_{n}", "kernel"))))

    for s in range(num_stage):
        src0 = (f"cost_reg_{s}",)
        dst0 = f"cost_regularization.{s}"
        for c in range(7):
            conv_bn(src0 + (f"conv{c}",), f"{dst0}.conv{c}", _conv3d_weight)
        for c in (7, 9, 11):
            conv_bn(src0 + (f"conv{c}",), f"{dst0}.conv{c}", _deconv3d_weight)
        put(f"{dst0}.prob.weight",
            _conv3d_weight(get(params, src0 + ("prob", "kernel"))))

    D = ("depth_net", "pixel_wise_net")
    for c in (0, 1):
        conv_bn(D + (f"conv{c}",), f"DepthNet.pixel_wise_net.conv{c}",
                _conv3d_weight)
    dense(D + ("conv2",), "DepthNet.pixel_wise_net.conv2", _conv3d_weight)
    return sd


def transmvsnet_reference_state_dict(blob, template: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """A reference TransMVSNet checkpoint → the port's ``TransMVSNet``
    state dict, keyed and shaped as ``template`` (the model's own
    ``state_dict()``).

    ``blob`` is the reference trainer's ``{"model": state_dict, …}`` or a
    bare state dict, its keys with or without DDP's ``module.`` prefix.
    ``num_batches_tracked`` is dropped (the template's is kept), and so is
    a ``pos_encoding`` entry the model has no place for (the sine PE holds
    no weights). Any other unknown key, a model key the checkpoint lacks,
    or a shape mismatch raises, naming the key. Tensors come out f32 on
    the CPU.
    """
    sd = blob.get("model", blob) if isinstance(blob, Mapping) else blob
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if not hasattr(value, "shape"):
            continue
        name = key.removeprefix("module.")
        if name.endswith("num_batches_tracked") or (
                ".pos_encoding." in name and name not in template):
            continue
        if name not in template:
            raise KeyError(f"checkpoint key {key} has no place in the model "
                           "(architecture/config mismatch?)")
        value = (value.detach().cpu() if isinstance(value, torch.Tensor)
                 else torch.as_tensor(np.asarray(value)))
        if tuple(template[name].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at {key}: model "
                f"{tuple(template[name].shape)} vs ckpt {tuple(value.shape)}")
        out[name] = value.to(torch.float32)
    for name, value in template.items():
        if name.endswith("num_batches_tracked"):
            out[name] = value.detach().cpu().clone()
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"checkpoint lacks {missing[0]} "
                       f"({len(missing)} model keys in all)")
    return out
