"""State carried across from the JAX package: its camera, tracker state
(``TrackState``, ``vido_slam_tpu/tracking.py:82-111``) and PRNG key, given as
numpy arrays (``jax.device_get`` of them), become the port's tensors.

The inputs are read by field name, so any object with the JAX field names
works; nothing of the JAX package is imported. MonoDepth2's, LiteFlowNet's
and Mask R-CNN's parameter dicts carry across the same way
(``monodepth2_state_dict_from_numpy``, ``liteflownet_state_dict_from_numpy``,
``maskrcnn_state_dict_from_numpy``), the three together as a
``PerceptionModel`` (``perception_model_from_numpy``); the first also
carries the pose nets' and the self-supervised trainer's dicts
(``PoseDecoder``, ``PoseCNN``, ``monodepth2_train.SelfSupModel``). The other way,
``convert_state_dict`` writes a torch state_dict in the JAX layout (the
JAX package's ``models/layers.py::convert_state_dict``), as the bundles of
``utils/checkpoint.py`` hold it.
"""

from __future__ import annotations

import numpy as np
import torch

from vido_slam_tpu_torch.frontend.features import FeatureSet
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.models.maskrcnn.model import (RESNET50_FPN,
                                                       MaskRCNNConfig)
from vido_slam_tpu_torch.models.perception import PerceptionModel
from vido_slam_tpu_torch.tracking import TrackState
from vido_slam_tpu_torch.utils.device import resolve_device

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def tensor_from_numpy(x, device=None) -> torch.Tensor:
    """float -> float32, int -> int32, bool -> bool; on ``device``, the
    card unless the caller asks for the CPU."""
    a = np.array(x)
    return torch.from_numpy(a).to(
        device=resolve_device(device), dtype=_DTYPES[a.dtype])


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A raw (2,) uint32 threefry key -> the port's int64 key."""
    return torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=resolve_device(device))


def jax_axes(key: str, ndim: int) -> tuple:
    """The torch dim of each dim of a tensor's JAX layout: a 4-D weight's
    JAX layout is ``transpose(2, 3, 1, 0)`` of the torch one (a Conv2d's
    OIHW -> HWIO; a ConvTranspose2d's (in, out / groups, kh, kw) -> (kh,
    kw, out / groups, in)), a 2-D ``*weight`` (a Linear's (out, in)) is
    transposed, others keep their dims."""
    if ndim == 4:
        return (2, 3, 1, 0)
    if ndim == 2 and key.endswith("weight"):
        return (1, 0)
    return tuple(range(ndim))


def convert_tensor(key: str, t) -> np.ndarray:
    """A torch tensor (or array) in the JAX package's layout, as numpy
    (``models/layers.py::convert_tensor`` there), its dims permuted by
    ``jax_axes``. The ``*_state_dict_from_numpy`` functions below invert
    it."""
    a = np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                   else t)
    return a.transpose(jax_axes(key, a.ndim))


def convert_state_dict(sd) -> dict:
    """A torch state_dict as the JAX package's parameter dict of numpy
    arrays (``convert_tensor`` of each entry)."""
    return {k: convert_tensor(k, v) for k, v in sd.items()}


def _param(value, dtype, transpose, device) -> torch.Tensor:
    """One JAX parameter (a numpy array, float32 or ml_dtypes' bfloat16)
    as a torch tensor in ``dtype``: None keeps a bf16 array bf16 (exactly:
    it is widened to float32 and narrowed back) and makes the rest float32;
    ``torch.bfloat16`` casts float32 values round-to-nearest-even, as
    ``jnp.astype(bfloat16)`` does. ``transpose(a)`` gives the torch
    layout."""
    a = np.asarray(value)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(transpose(a.astype(np.float32)),
                                  order="C"))
    if dtype is None and bf16:
        dtype = torch.bfloat16
    return t.to(device=device, dtype=dtype or torch.float32)


def _oihw(a):
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def monodepth2_state_dict_from_numpy(params, device=None,
                                     dtype=None) -> dict:
    """The JAX package's MonoDepth2 parameter dict (numpy arrays, conv
    kernels HWIO) as tensors in torch layout on ``device`` (the card unless
    the caller asks for the CPU), for
    ``MonoDepth2.load_state_dict(strict=True)``: a 4-D array goes through
    ``transpose(3, 2, 0, 1)`` (HWIO -> OIHW); 1-D arrays pass unchanged.
    float32, or bf16 for bf16 arrays or ``dtype=torch.bfloat16``
    (``_param``)."""
    dev = resolve_device(device)
    return {key: _param(value, dtype, _oihw, dev)
            for key, value in params.items()}


def liteflownet_state_dict_from_numpy(params, dtype=None) -> dict:
    """The JAX package's LiteFlowNet parameter dict (numpy arrays, conv
    kernels HWIO) as CPU tensors in torch layout, for
    ``LiteFlowNet.load_state_dict(strict=True)``: a 4-D array goes through
    ``transpose(3, 2, 0, 1)``, the inverse of ``layers.convert_tensor``
    (HWIO -> OIHW for a Conv2d, (kh, kw, 1, C) -> (C, 1, kh, kw) for the
    grouped ConvTranspose2d); 1-D arrays pass unchanged. float32, or bf16
    for bf16 arrays or ``dtype=torch.bfloat16`` (``_param``)."""
    return {key: _param(value, dtype, _oihw, "cpu")
            for key, value in params.items()}


def maskrcnn_state_dict_from_numpy(params, device=None, dtype=None) -> dict:
    """The JAX package's Mask R-CNN parameter dict (numpy arrays) as
    tensors in torch layout on ``device`` (the card unless the caller asks
    for the CPU), for ``MaskRCNN.load_state_dict(strict=True)``: a 4-D
    array goes through ``transpose(3, 2, 0, 1)`` (HWIO -> OIHW for a
    Conv2d; conv5_mask's stored (kh, kw, cout, cin) -> the ConvTranspose2d's
    (cin, cout, kh, kw)), a 2-D ``*.weight`` (a Linear stored (in, out))
    through ``.T``; 1-D arrays pass unchanged. float32, or bf16 for bf16
    arrays or ``dtype=torch.bfloat16`` (``_param``)."""
    dev = resolve_device(device)

    def layout(key):
        def fn(a):
            if a.ndim == 2 and key.endswith(".weight"):
                return a.T
            return _oihw(a)
        return fn
    return {key: _param(value, dtype, layout(key), dev)
            for key, value in params.items()}


def perception_model_from_numpy(height: int, width: int, depth_params,
                                flow_params, mask_params,
                                mask_cfg: MaskRCNNConfig = RESNET50_FPN,
                                device=None, **kwargs) -> PerceptionModel:
    """A ``PerceptionModel`` on ``device`` holding the JAX package's three
    parameter dicts (numpy arrays, float32 or bf16): MonoDepth2's,
    LiteFlowNet's and Mask R-CNN's. ``kwargs`` go to ``PerceptionModel``
    (its dtype options cast the nets as they cast seeded ones)."""
    dev = resolve_device(device)
    return PerceptionModel(
        height, width, mask_cfg, device=dev,
        depth_state=monodepth2_state_dict_from_numpy(depth_params, dev),
        flow_state=liteflownet_state_dict_from_numpy(flow_params),
        mask_state=maskrcnn_state_dict_from_numpy(mask_params, dev),
        **kwargs)


def camera_from_numpy(cam) -> Camera:
    return Camera.create(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                         dist=np.asarray(cam.dist), width=cam.width,
                         height=cam.height, bf=cam.bf, fps=cam.fps)


def feature_set_from_numpy(fs, device=None) -> FeatureSet:
    return FeatureSet(*(tensor_from_numpy(getattr(fs, f), device)
                        for f in FeatureSet._fields))


def track_state_from_numpy(state, device=None) -> TrackState:
    device = resolve_device(device)
    fields = {}
    for f in TrackState._fields:
        v = getattr(state, f)
        if f in ("stat", "obj"):
            fields[f] = feature_set_from_numpy(v, device)
        elif f == "key":
            fields[f] = key_from_numpy(v, device)
        else:
            fields[f] = tensor_from_numpy(v, device)
    return TrackState(**fields)
