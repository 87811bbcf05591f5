"""VGG feature extractors (counterpart of ``nerfstyle_tpu/models/vgg.py``):
:class:`VGG16FeatureExtractor`, which the style stage runs, and
:class:`VGG19FeatureExtractor` (library API, as in JAX), both on
:class:`VGGFeatureExtractor`.

The same node-key grammar as the reference's torchvision extractor
(``conv3_1`` / ``relu3``; a block-level key concatenates all its layers), the
same ImageNet normalization, fp32 throughout.  The convolutions and pools are
``torch.nn.functional.conv2d`` and ``max_pool2d`` (cuDNN on the card), as the
JAX package leaves them to ``lax.conv_general_dilated``; cuDNN's TF32 mode is
switched off (``torch.backends.cudnn.allow_tf32 = False``), because a TF32
convolution is a different function.  The ReLU is :class:`_Relu`, whose
gradient at an exactly-zero pre-activation is 0.5, as that of the JAX
package's ``jnp.maximum(x, 0.0)`` (``torch.relu``'s is 0).  A max-pool tie
routes its gradient to the window's first element in row-major order, as
XLA's select-and-scatter does, on the CPU and on the card alike.  The public
interface speaks [N, C, H, W], like the JAX extractor's.

Weights: torchvision is not used.  Pretrained weights load from a local file
when present, searched in this order (``<kind>`` is ``vgg16`` or
``vgg19``): the ``NERFSTYLE_<KIND>_WEIGHTS`` environment variable,
``~/.cache/nerfstyle/<kind>.npz`` or ``.pth``, then the torch hub checkpoint
cache (``$TORCH_HOME`` or ``~/.cache/torch``, ``hub/checkpoints/<kind>-*.pth``,
read with
``torch.load(weights_only=True)``).  Every file is checked against the
port's copy of the weight manifest (``vgg_manifest.json``: keys, shapes,
dtypes, and SHA256 where stamped).  Without weights the extractor falls back
to fixed-seed He-normal filters drawn from a ``torch.Generator``: a
deliberate difference from the JAX package, whose fallback filters come from
``jax.random`` and cannot be drawn here.  The parity tests carry the JAX
filters over with :func:`vgg_params_from_numpy`.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import DeviceLike, resolve_device, utils

logger = utils.create_logger(__name__)

# Channel plan per block (torchvision VGG16 and VGG19 'features').
_VGG16_BLOCKS = [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512], [512, 512, 512]]
_VGG19_BLOCKS = [[64, 64], [128, 128], [256, 256, 256, 256], [512, 512, 512, 512],
                 [512, 512, 512, 512]]
# torchvision 'features.N' indices of each conv layer.
VGG16_LAYERS = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
VGG19_LAYERS = [[0, 2], [5, 7], [10, 12, 14, 16], [19, 21, 23, 25], [28, 30, 32, 34]]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

VggParams = List[Tuple[torch.Tensor, torch.Tensor]]  # (OIHW weight, bias) per conv


def _init_params(blocks: Sequence[Sequence[int]], seed: int = 7) -> VggParams:
    """Fixed-seed He-normal fallback filters (zero bias), OIHW."""
    gen = torch.Generator().manual_seed(seed)
    params, c_in = [], 3
    for block in blocks:
        for c_out in block:
            std = (2.0 / (9 * c_in)) ** 0.5
            params.append((torch.randn((c_out, c_in, 3, 3), generator=gen) * std,
                           torch.zeros((c_out,))))
            c_in = c_out
    return params


def vgg_params_from_numpy(params) -> VggParams:
    """The JAX extractor's params (a list of (HWIO weight, bias) arrays) ->
    the port's (OIHW weight, bias) tensors."""
    return [(torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))),
             torch.from_numpy(np.array(b))) for w, b in params]


def load_manifest(kind: str) -> Dict[str, object]:
    """The weight manifest: required array keys, shapes, dtypes and, where
    stamped, the SHA256 of each array's raw bytes."""
    with open(Path(__file__).parent / "vgg_manifest.json") as f:
        return json.load(f)[kind]


def validate_weights(kind: str, raw: Dict[str, np.ndarray], layers=None, sidecar=None) -> None:
    """Check loaded arrays against the manifest (keys, shapes, dtypes, and
    SHA256 where stamped, in the manifest or in a ``<weights>.manifest.json``
    sidecar); ``layers`` restricts the check to the listed torchvision
    indices.  Raises ValueError on any mismatch: a wrong weight file would
    give plausible-looking features that are not VGG's."""
    man = load_manifest(kind)["arrays"]
    stamped = {}
    if sidecar is not None and Path(sidecar).exists():
        with open(sidecar) as f:
            stamped = json.load(f).get("sha256", {})
    want = set(man)
    if layers is not None:
        idxs = {i for block in layers for i in block}
        want = {k for k in want if int(k.split(".")[1]) in idxs}
    missing = sorted(want - set(raw))
    if missing:
        raise ValueError(f"{kind} weight file is missing arrays: {missing[:4]}")
    for key in sorted(want):
        arr = np.asarray(raw[key])
        spec = man[key]
        if list(arr.shape) != list(spec["shape"]) or str(arr.dtype) != spec["dtype"]:
            raise ValueError(f"{kind} weight {key}: got {list(arr.shape)}/{arr.dtype}, "
                             f"manifest says {spec['shape']}/{spec['dtype']}")
        sha = stamped.get(key) or spec.get("sha256")
        if sha and hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest() != sha:
            raise ValueError(f"{kind} weight {key}: SHA256 mismatch")


def load_torch_weights(path: Union[str, Path], layers, kind: Optional[str] = None) -> VggParams:
    """A torchvision state dict (``.pth``) or an ``.npz`` of
    ``features.N.weight`` / ``features.N.bias`` arrays -> conv params,
    validated against the manifest when ``kind`` is given."""
    path = Path(path)
    if path.suffix == ".npz":
        raw = dict(np.load(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        raw = {k: v.numpy() for k, v in sd.items()}
    if kind is not None:
        validate_weights(kind, raw, layers=layers, sidecar=Path(str(path) + ".manifest.json"))
    return [(torch.from_numpy(np.array(raw[f"features.{i}.weight"])),
             torch.from_numpy(np.array(raw[f"features.{i}.bias"])))
            for block in layers for i in block]


def find_weights(kind: str) -> Optional[Path]:
    """Locate pretrained weights for ``kind`` ("vgg16" or "vgg19"), or None."""
    env = os.environ.get(f"NERFSTYLE_{kind.upper()}_WEIGHTS")
    if env and Path(env).exists():
        return Path(env)
    for suffix in (".npz", ".pth"):
        p = Path.home() / ".cache" / "nerfstyle" / f"{kind}{suffix}"
        if p.exists():
            return p
    torch_home = Path(os.environ.get("TORCH_HOME", Path.home() / ".cache" / "torch"))
    hits = sorted((torch_home / "hub" / "checkpoints").glob(f"{kind}-*.pth"))
    return hits[0] if hits else None


_HALF = torch.tensor(0.5)


class _Relu(torch.autograd.Function):
    """max(x, 0) with ``jnp.maximum``'s gradient: 1 above 0, 0.5 at exactly
    0 (the tie splits between the two arguments), 0 below.  With zero
    biases (the fallback filters) a pre-activation is exactly 0 wherever the
    receptive field is all zeros; ``torch.relu`` would drop its gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # A CPU scalar operand: no host-to-device copy (a sync) a call.
        return g * torch.heaviside(x, _HALF.to(x.dtype))


def relu(x: torch.Tensor) -> torch.Tensor:
    """The extractor's ReLU (:class:`_Relu`)."""
    return _Relu.apply(x)


class VGGFeatureExtractor:
    """Feature extractor with the reference's key grammar: ``conv<b>_<l>``
    or ``relu<b>_<l>`` for a layer, ``conv<b>`` or ``relu<b>`` for a whole
    block (its layers concatenated on channels).  A subclass names the
    network: ``kind``, its channel plan ``blocks`` and its torchvision
    ``layers``."""

    kind = "vgg16"
    blocks = _VGG16_BLOCKS
    layers = VGG16_LAYERS

    def __init__(self, keys: Union[str, List[str]], device=None,
                 params: Optional[VggParams] = None):
        if isinstance(keys, str):
            keys = [keys]
        # (out_key, [(block, layer in block, want_relu)])
        self.keys: List[Tuple[str, List[Tuple[int, int, bool]]]] = []
        for kname in keys:
            m = re.match(r"^(conv|relu)([1-5])(?:_([1-4]))?$", kname)
            if not m:
                raise ValueError(f'"{kname}" is an invalid identifier')
            op, block_s, layer_s = m.groups()
            b = int(block_s) - 1
            layer_ids = range(len(self.layers[b])) if layer_s is None else [int(layer_s) - 1]
            self.keys.append((kname, [(b, i, op == "relu") for i in layer_ids]))
        self._max_block = max(b for _, taps in self.keys for b, _, _ in taps)
        self._needed = {tap for _, taps in self.keys for tap in taps}

        # Only the blocks up to the deepest requested tap run, so only their
        # weights are loaded.
        used_blocks = self.blocks[: self._max_block + 1]
        used_layers = self.layers[: self._max_block + 1]
        if params is not None:
            self.pretrained = False
        else:
            path = find_weights(self.kind)
            self.pretrained = path is not None
            if path is not None:
                params = load_torch_weights(path, used_layers, kind=self.kind)
                logger.info("Loaded %s weights from %s", self.kind, path)
            else:
                params = _init_params(used_blocks)
                logger.warning(
                    "No pretrained %s weights found (set NERFSTYLE_%s_WEIGHTS); using "
                    "fixed-seed random filters: style losses work but differ from VGG's.",
                    self.kind, self.kind.upper())
        n_used = sum(len(b) for b in used_blocks)
        if len(params) < n_used:
            raise ValueError(f"{self.kind} needs {n_used} conv layers up to block "
                             f"{self._max_block + 1}, got {len(params)}")
        torch.backends.cudnn.allow_tf32 = False  # a TF32 convolution is another function
        dev = None if device is None else torch.device(device)
        self.params = [(w.to(dev, torch.float32), b.to(dev, torch.float32))
                       for w, b in params[:n_used]]
        self._mean = torch.tensor(_IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
        self._std = torch.tensor(_IMAGENET_STD, device=dev).view(1, 3, 1, 1)

    def _forward(self, x: torch.Tensor) -> Dict[Tuple[int, int, bool], torch.Tensor]:
        """The conv stack up to the deepest tap; every needed tap, NCHW."""
        x = (x.to(torch.float32) - self._mean) / self._std
        taps: Dict[Tuple[int, int, bool], torch.Tensor] = {}
        p = 0
        for b, block in enumerate(self.blocks[: self._max_block + 1]):
            for i in range(len(block)):
                w, bias = self.params[p]
                p += 1
                x = F.conv2d(x, w, bias, padding=1)
                if (b, i, False) in self._needed:
                    taps[(b, i, False)] = x
                x = relu(x)
                if (b, i, True) in self._needed:
                    taps[(b, i, True)] = x
            if b < self._max_block:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [C, H, W] or [N, C, H, W] in [0, 1] -> {key: [N, C', H', W']}."""
        if x.dim() == 3:
            x = x[None]
        taps = self._forward(x)
        return {kname: torch.cat([taps[t] for t in tap_list], dim=1)
                for kname, tap_list in self.keys}


class VGG16FeatureExtractor(VGGFeatureExtractor):
    kind = "vgg16"
    blocks = _VGG16_BLOCKS
    layers = VGG16_LAYERS


class VGG19FeatureExtractor(VGGFeatureExtractor):
    kind = "vgg19"
    blocks = _VGG19_BLOCKS
    layers = VGG19_LAYERS


def test_fx(fx_type: str, h: int = 224, w: int = 224, device: DeviceLike = None) -> None:
    """Smoke harness (JAX's ``test_fx``): an extractor of ``fx_type``
    (``vgg16`` or ``vgg19``) on every layer and block key runs a zero
    [1, 3, h, w] image on ``device`` (``cuda`` unless given) and prints each
    feature's size."""
    cls = {"vgg16": VGG16FeatureExtractor, "vgg19": VGG19FeatureExtractor}[fx_type]
    all_layers = [
        f"conv{i + 1}_{j + 1}" for i, lvl in enumerate(cls.layers) for j in range(len(lvl))
    ] + [f"conv{i + 1}" for i in range(len(cls.layers))]
    dev = resolve_device(device)
    fx = cls(all_layers, device=dev)
    out = fx(torch.zeros((1, 3, h, w), device=dev))
    for k, v in out.items():
        print(f"Feature: {k}, size: {tuple(v.shape)}")


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Print the feature sizes of a VGG extractor.")
    parser.add_argument("fx_type", nargs="?", default="vgg16", choices=("vgg16", "vgg19"))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    test_fx(args.fx_type, device=args.device)
