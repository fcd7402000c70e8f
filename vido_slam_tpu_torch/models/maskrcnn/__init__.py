"""Mask R-CNN (FPN, FrozenBN ResNet/ResNeXt) in NCHW — counterpart of
``vido_slam_tpu/models/maskrcnn``: ``backbone``, ``rpn``, ``roi_heads`` and
``model`` (``MaskRCNN``, ``maskrcnn_inference``, ``paste_semantic_mask``)."""
