"""The port's Detectron caffe2 loader (``models/maskrcnn/c2_loading.py``,
``MaskRCNN.load_c2``) against the JAX package's, on synthetic blob dicts
with the real Detectron blob-name grammar of an e2e Mask R-CNN FPN
checkpoint (built here at full shapes, as tests/test_c2_loading.py's
``make_c2_blobs`` builds them; nothing reads a real checkpoint).

Bars: the renamed keys, the translated dict and the ``filled`` /
``unmatched`` lists equal the JAX loader's; the port's loaded
``state_dict()`` equals, key for key and bit for bit, the JAX loader's
aligned dict put in torch layout by ``convert.maskrcnn_state_dict_from_
numpy``, running statistics included (mean 0, variance 1 for every
FrozenBN, whatever the model held before the load).
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from vido_slam_tpu.models.maskrcnn import c2_loading as jc2
from vido_slam_tpu.models.maskrcnn import model as jm
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.models.maskrcnn import c2_loading as tc2
from vido_slam_tpu_torch.models.maskrcnn.model import (RESNET50_FPN,
                                                       RESNEXT101_FPN,
                                                       MaskRCNN)

torch.set_num_threads(1)

STAGE_BLOCKS = {"R-50": (3, 4, 6, 3), "R-101": (3, 4, 23, 3)}
ARCHS = {"R-50": (RESNET50_FPN, jm.RESNET50_FPN, "R-50-FPN", "R-50"),
         "X-101": (RESNEXT101_FPN, jm.RESNEXT101_FPN, "R-101-FPN", "R-101")}


def make_c2_blobs(arch, groups, width_per_group, seed=0):
    """A Detectron blob dict at full shapes: stem, stages, FPN, RPN, box
    and mask heads, the ImageNet fc head and the momentum blobs that the
    loader drops."""
    rs = np.random.RandomState(seed)
    blobs = {}

    def t(*shape):
        return (rs.randn(*shape) * 0.05).astype(np.float32)

    def add(name, *shape):
        blobs[name] = t(*shape)
        if name.endswith("_w"):
            blobs[name + "_momentum"] = t(*shape)

    def affine(prefix, c):
        blobs[prefix + "_s"] = t(c) + 1.0
        blobs[prefix + "_b"] = t(c)

    add("conv1_w", 64, 3, 7, 7)
    affine("res_conv1_bn", 64)
    width = groups * width_per_group
    cin, last = 64, []
    for si, nb in enumerate(STAGE_BLOCKS[arch]):
        planes, cout, S = width * 2 ** si, 256 * 2 ** si, si + 2
        for b in range(nb):
            q = f"res{S}_{b}"
            add(f"{q}_branch2a_w", planes, cin if b == 0 else cout, 1, 1)
            affine(f"{q}_branch2a_bn", planes)
            add(f"{q}_branch2b_w", planes, planes // groups, 3, 3)
            affine(f"{q}_branch2b_bn", planes)
            add(f"{q}_branch2c_w", cout, planes, 1, 1)
            affine(f"{q}_branch2c_bn", cout)
            if b == 0:
                add(f"{q}_branch1_w", cout, cin, 1, 1)
                affine(f"{q}_branch1_bn", cout)
        cin = cout
        last.append(f"res{S}_{nb - 1}")
    for idx, lname in enumerate(last, 1):
        lat = "_lateral" if idx < 4 else ""
        add(f"fpn_inner_{lname}_sum{lat}_w", 256, 256 * 2 ** (idx - 1), 1, 1)
        blobs[f"fpn_inner_{lname}_sum{lat}_b"] = t(256)
        add(f"fpn_{lname}_sum_w", 256, 256, 3, 3)
        blobs[f"fpn_{lname}_sum_b"] = t(256)
    add("conv_rpn_fpn2_w", 256, 256, 3, 3)
    blobs["conv_rpn_fpn2_b"] = t(256)
    add("rpn_cls_logits_fpn2_w", 3, 256, 1, 1)
    blobs["rpn_cls_logits_fpn2_b"] = t(3)
    add("rpn_bbox_pred_fpn2_w", 12, 256, 1, 1)
    blobs["rpn_bbox_pred_fpn2_b"] = t(12)
    for name, cout, cin_ in (("fc6", 1024, 256 * 7 * 7), ("fc7", 1024, 1024),
                             ("cls_score", 81, 1024),
                             ("bbox_pred", 324, 1024)):
        add(f"{name}_w", cout, cin_)
        blobs[f"{name}_b"] = t(cout)
    for i in range(1, 5):
        add(f"_[mask]_fcn{i}_w", 256, 256, 3, 3)
        blobs[f"_[mask]_fcn{i}_b"] = t(256)
    add("conv5_mask_w", 256, 256, 2, 2)
    blobs["conv5_mask_b"] = t(256)
    add("mask_fcn_logits_w", 81, 256, 1, 1)
    blobs["mask_fcn_logits_b"] = t(81)
    add("pred_w", 1000, 2048)
    blobs["pred_b"] = t(1000)
    return blobs


@pytest.fixture(scope="module", params=["R-50", "X-101"])
def loaded(request, tmp_path_factory):
    """Both loaders on one pickle: (arch, blobs, JAX aligned params and
    lists, the port model after load_c2 and its lists)."""
    arch = request.param
    tcfg, jcfg, conv_body, stages = ARCHS[arch]
    blobs = make_c2_blobs(stages, tcfg.resnet.num_groups,
                          tcfg.resnet.width_per_group)
    pkl = tmp_path_factory.mktemp("c2") / "model.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    state = jc2.translate_c2_blobs(jc2.load_c2_pickle(str(pkl)), conv_body)
    init = jm.init_maskrcnn_params(jax.random.PRNGKey(0), jcfg)
    jparams, jfilled, junmatched = jc2.align_c2_to_model(state, init)
    model = MaskRCNN(tcfg, seed=1, device="cpu")
    # the trap: statistics other than 0 / 1 before the load
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith((".running_mean", ".running_var")):
                v.uniform_(2.0, 3.0)
    filled, unmatched = model.load_c2(str(pkl), conv_body)
    return dict(arch=arch, conv_body=conv_body, stages=stages, blobs=blobs,
                jparams={k: np.asarray(v) for k, v in jparams.items()},
                jfilled=jfilled, junmatched=junmatched, model=model,
                filled=filled, unmatched=unmatched)


def test_renamed_keys_equal_jax(loaded):
    keys = sorted(loaded["blobs"])
    stage_names = tc2.C2_STAGE_NAMES[loaded["stages"]]
    assert stage_names == jc2.C2_STAGE_NAMES[loaded["stages"]]
    assert tc2.rename_c2_keys(keys, stage_names) == jc2.rename_c2_keys(
        keys, stage_names)
    t = tc2.translate_c2_blobs(loaded["blobs"], loaded["conv_body"])
    j = jc2.translate_c2_blobs(loaded["blobs"], loaded["conv_body"])
    assert list(t) == list(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    assert "layer1.0.conv1.weight" in t and "rpn.head.conv.weight" in t
    assert not any("momentum" in k for k in t)


def test_filled_and_unmatched_equal_jax(loaded):
    assert sorted(loaded["filled"]) == sorted(loaded["jfilled"])
    assert loaded["unmatched"] == loaded["junmatched"]
    assert loaded["filled"] == []
    assert sorted(loaded["unmatched"]) == ["fc1000.bias", "fc1000.weight"]


def test_loaded_state_equals_jax_aligned(loaded):
    want = convert.maskrcnn_state_dict_from_numpy(loaded["jparams"],
                                                  device="cpu")
    got = loaded["model"].state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    n_stats = 0
    for k, v in got.items():
        if k.endswith(".running_mean"):
            assert torch.equal(v, torch.zeros_like(v)), k
            n_stats += 1
        elif k.endswith(".running_var"):
            assert torch.equal(v, torch.ones_like(v)), k
    assert n_stats > 50
    np.testing.assert_array_equal(
        got["backbone.body.stem.conv1.weight"].numpy(),
        loaded["blobs"]["conv1_w"])
    np.testing.assert_array_equal(
        got["roi_heads.box.feature_extractor.fc6.weight"].numpy(),
        loaded["blobs"]["fc6_w"])


def test_blob_dict_and_pickle_load_alike(loaded):
    """load_c2 takes the blob dict as well as the pickle's path."""
    model = MaskRCNN(ARCHS[loaded["arch"]][0], seed=2, device="cpu")
    filled, unmatched = model.load_c2(loaded["blobs"], loaded["conv_body"])
    assert (filled, unmatched) == (loaded["filled"], loaded["unmatched"])
    a, b = model.state_dict(), loaded["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_wrong_shape_raises():
    state = {"backbone.body.stem.conv1.weight": np.zeros((64, 3, 5, 5),
                                                         np.float32)}
    model_state = MaskRCNN(RESNET50_FPN, device="cpu").state_dict()
    with pytest.raises(ValueError, match="stem.conv1.weight"):
        tc2.align_c2_to_model(state, model_state)


def test_load_c2_pickle_blobs_key(tmp_path):
    pkl = tmp_path / "x.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": {"a_w": np.ones(3), "lr": 0.1}}, f)
    assert list(tc2.load_c2_pickle(str(pkl))) == ["a_w"]
    assert list(tc2.load_c2_pickle(str(pkl))) == list(
        jc2.load_c2_pickle(str(pkl)))
    state = {"backbone.body.layer2.0.conv2.weight": np.zeros(1),
             "backbone.body.layer1.0.conv2.weight": np.zeros(1)}
    dcn = (False, True, False, False)
    assert tc2.remap_dcn_conv2(state, dcn).keys() == \
        jc2.remap_dcn_conv2(state, dcn).keys()
