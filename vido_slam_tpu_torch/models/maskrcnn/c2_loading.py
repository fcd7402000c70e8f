"""Detectron / caffe2 checkpoint translation — counterpart of
``vido_slam_tpu/models/maskrcnn/c2_loading.py``, the loader of the
reference node's *deployed* detector weights.

The reference's ROS node runs ``e2e_mask_rcnn_X_101_32x8d_FPN_1x_caffe2.yaml``
(run_mask_rcnn.py:30), whose WEIGHT is a Detectron caffe2 pickle that
maskrcnn_benchmark/utils/c2_model_loading.py:12-206 translates (the
ordered key-rename chain of _rename_basic_resnet_weights /
_rename_fpn_weights / _rename_weights_for_resnet plus the DCN conv2 remap)
and model_serialization.py:10-58 aligns to the module tree by the longest
key suffix. Pure numpy, copied from the JAX package:

  load_c2_pickle       — _load_c2_pickled_weights (latin1, "blobs" key)
  rename_c2_keys       — the exact ordered str.replace chain
  translate_c2_blobs   — momentum-drop + rename (+ optional DCN remap)
  align_c2_to_model    — longest-suffix match onto the port module's
                         ``state_dict()``; the blobs are already in torch
                         layout, so no transform; every FrozenBN that
                         takes a blob gets running mean 0 and variance 1
                         (C2 folds BN into scale and bias, and FrozenBN
                         has no epsilon, so the arithmetic is the
                         AffineChannel's)

``MaskRCNN.load_c2`` runs the three on a pickle or a blob dict.
X-101-32x8d rides the "R-101-FPN" conv body (the caffe2 yaml sets only
NUM_GROUPS=32/WIDTH_PER_GROUP=8 on top), so its stage names are R-101's.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# Detectron blob names per conv body (c2_model_loading.py:173-177): the
# FPN lateral/sum blobs embed the last block index of each stage.
C2_STAGE_NAMES = {
    "R-50": ("1.2", "2.3", "3.5", "4.2"),
    "R-101": ("1.2", "2.3", "3.22", "4.2"),
    "R-152": ("1.2", "2.7", "3.35", "4.2"),
}

# Ordered global replaces of _rename_basic_resnet_weights
# (c2_model_loading.py:12-63). Order is load-bearing: ".b"->".bias"
# deliberately mangles "branch"/"bbox" and the ".biasranch"/".biasbox"
# entries repair them, exactly as the reference does.
_BASIC_RENAMES: Tuple[Tuple[str, str], ...] = (
    ("_", "."),
    (".w", ".weight"),
    (".bn", "_bn"),
    (".b", ".bias"),
    ("_bn.s", "_bn.scale"),
    (".biasranch", ".branch"),
    ("bbox.pred", "bbox_pred"),
    ("cls.score", "cls_score"),
    ("res.conv1_", "conv1_"),
    # RPN / Faster R-CNN
    (".biasbox", ".bbox"),
    ("conv.rpn", "rpn.conv"),
    ("rpn.bbox.pred", "rpn.bbox_pred"),
    ("rpn.cls.logits", "rpn.cls_logits"),
    # AffineChannel -> (Frozen)BatchNorm naming
    ("_bn.scale", "_bn.weight"),
    ("conv1_bn.", "bn1."),
    ("res2.", "layer1."),
    ("res3.", "layer2."),
    ("res4.", "layer3."),
    ("res5.", "layer4."),
    (".branch2a.", ".conv1."),
    (".branch2a_bn.", ".bn1."),
    (".branch2b.", ".conv2."),
    (".branch2b_bn.", ".bn2."),
    (".branch2c.", ".conv3."),
    (".branch2c_bn.", ".bn3."),
    (".branch1.", ".downsample.0."),
    (".branch1_bn.", ".downsample.1."),
    # GroupNorm checkpoints
    ("conv1.gn.s", "bn1.weight"),
    ("conv1.gn.bias", "bn1.bias"),
    ("conv2.gn.s", "bn2.weight"),
    ("conv2.gn.bias", "bn2.bias"),
    ("conv3.gn.s", "bn3.weight"),
    ("conv3.gn.bias", "bn3.bias"),
    ("downsample.0.gn.s", "downsample.1.weight"),
    ("downsample.0.gn.bias", "downsample.1.bias"),
)

# Post-FPN renames: RPN fpn2 collapse (_rename_fpn_weights tail,
# c2_model_loading.py:76-81) then mask / keypoint heads and the final
# rpn.head nesting (_rename_weights_for_resnet, :100-112).
_POST_FPN_RENAMES: Tuple[Tuple[str, str], ...] = (
    ("rpn.conv.fpn2", "rpn.conv"),
    ("rpn.bbox_pred.fpn2", "rpn.bbox_pred"),
    ("rpn.cls_logits.fpn2", "rpn.cls_logits"),
    ("mask.fcn.logits", "mask_fcn_logits"),
    (".[mask].fcn", "mask_fcn"),
    ("conv5.mask", "conv5_mask"),
    ("kps.score.lowres", "kps_score_lowres"),
    ("kps.score", "kps_score"),
    ("conv.fcn", "conv_fcn"),
)


def rename_c2_keys(keys: Sequence[str],
                   stage_names: Sequence[str]) -> List[str]:
    """C2 blob names -> maskrcnn_benchmark state_dict names, in the exact
    replace order of _rename_weights_for_resnet (c2_model_loading.py:86-112).
    `stage_names` per C2_STAGE_NAMES (FPN blob suffixes)."""
    # X-101 classifier head collision guard (c2_model_loading.py:88-90);
    # pre-replace form — the basic chain turns these into fc1000.{bias,weight}
    out = ["fc1000_b" if k == "pred_b"
           else "fc1000_w" if k == "pred_w" else k for k in keys]
    for old, new in _BASIC_RENAMES:
        out = [k.replace(old, new) for k in out]
    # FPN lateral/sum blobs (_rename_fpn_weights, :66-74); the basic pass
    # already rewrote res{2..5}. -> layer{1..4}. inside these names
    for idx, sname in enumerate(stage_names, 1):
        suffix = ".lateral" if idx < 4 else ""
        out = [k.replace(f"fpn.inner.layer{sname}.sum{suffix}",
                         f"fpn_inner{idx}") for k in out]
        out = [k.replace(f"fpn.layer{sname}.sum", f"fpn_layer{idx}")
               for k in out]
    for old, new in _POST_FPN_RENAMES:
        out = [k.replace(old, new) for k in out]
    return [k.replace("rpn.", "rpn.head.") for k in out]


def load_c2_pickle(path: str) -> Dict[str, np.ndarray]:
    """_load_c2_pickled_weights (c2_model_loading.py:133-143): latin1
    pickle, blobs live under the "blobs" key when present."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    blobs = data["blobs"] if isinstance(data, dict) and "blobs" in data \
        else data
    return {k: np.asarray(v) for k, v in blobs.items()
            if isinstance(v, np.ndarray) or np.ndim(v) > 0}


def remap_dcn_conv2(state: Dict[str, np.ndarray],
                    stage_with_dcn: Sequence[bool]) -> Dict[str, np.ndarray]:
    """conv2.{weight,bias} -> conv2.conv.{weight,bias} in DCN stages
    (_rename_conv_weights_for_deformable_conv_layers,
    c2_model_loading.py:146-171). The offset conv has no C2 counterpart
    (Detectron trains it from zero-init when fine-tuning)."""
    out = dict(state)
    for ix, with_dcn in enumerate(stage_with_dcn, 1):
        if not with_dcn:
            continue
        pat = re.compile(rf".*layer{ix}.*conv2.*")
        for key in sorted(state.keys()):
            if pat.match(key) is None:
                continue
            for param in ("weight", "bias"):
                if f"conv2.{param}" not in key:
                    continue
                out[key.replace(f"conv2.{param}", f"conv2.conv.{param}")] \
                    = out.pop(key)
    return out


def translate_c2_blobs(blobs: Dict[str, np.ndarray],
                       conv_body: str = "R-101",
                       stage_with_dcn: Sequence[bool] = ()) \
        -> Dict[str, np.ndarray]:
    """Full C2 -> maskrcnn_benchmark key translation (NCHW values kept)."""
    arch = conv_body.replace("-C4", "").replace("-C5", "") \
        .replace("-FPN", "").replace("-RETINANET", "")
    original = sorted(blobs.keys())
    renamed = rename_c2_keys(original, C2_STAGE_NAMES[arch])
    state = {}
    for old, new in zip(original, renamed):
        if "_momentum" in old:  # c2_model_loading.py:120-121
            continue
        state[new] = blobs[old]
    if any(stage_with_dcn):
        state = remap_dcn_conv2(state, stage_with_dcn)
    return state


def align_c2_to_model(state: Dict[str, np.ndarray], model_state: Dict) \
        -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Longest-suffix match (model_serialization.py:10-58) of the
    translated blobs onto a module's ``state_dict()``. Returns (state,
    filled_from_init, unmatched_loaded):
      state            — a full state_dict: matched keys carry the C2
                         values as float32 CPU tensors, the rest keep
                         ``model_state``'s; the running statistics of each
                         norm that took a blob are set to mean 0, var 1
      filled_from_init — model keys that found no C2 blob, EXCLUDING the
                         running statistics (anything listed is a real
                         gap, e.g. a DCN offset conv)
      unmatched_loaded — loaded keys no model key consumed (fc1000, ...)
    """
    out = dict(model_state)
    used = set()
    filled = []
    for mk in model_state.keys():
        best = None
        for lk in state.keys():
            if mk.endswith(lk) and (best is None or len(lk) > len(best)):
                best = lk
        if best is None:
            if not mk.endswith((".running_mean", ".running_var")):
                filled.append(mk)
            continue
        used.add(best)
        v = np.asarray(state[best], np.float32)
        want = tuple(model_state[mk].shape)
        if tuple(v.shape) != want:
            raise ValueError(
                f"C2 blob for {mk} has shape {v.shape}, model wants {want}")
        out[mk] = torch.from_numpy(np.array(v))
        stem = mk.rsplit(".", 1)[0]
        if stem + ".running_mean" in model_state:
            like = model_state[stem + ".running_mean"]
            out[stem + ".running_mean"] = torch.zeros(like.shape)
            out[stem + ".running_var"] = torch.ones(like.shape)
    unmatched = [k for k in state.keys() if k not in used]
    return out, filled, unmatched
