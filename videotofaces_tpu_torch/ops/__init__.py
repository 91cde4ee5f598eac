"""Device-side ops on torch tensors: box math, fixed-capacity NMS, exact
adaptive-average pooling, distance Gram matrices, K-means and cluster
scores, and the hand-written CUDA kernels with their plain PyTorch versions
(``pnet_kernel``, ``crops_kernel``, ``resize_kernel``, ``roi_align_kernel``;
built by ``_cuda``), anchors, the R-CNN preprocess resize and multilevel
RoIAlign.

Dynamic-size results (filtering, NMS, selection) are fixed-capacity padded
buffers plus validity masks, as in the JAX package.
"""

from .boxes import (  # noqa: F401
    decode_boxes,
    convert_to_cwh,
    clamp_to_canvas,
    scale_boxes,
    box_iou_matrix,
    small_boxes_mask,
)
from .anchors import make_anchors, get_priors  # noqa: F401
from .nms import nms_keep_mask, batched_nms_topk, iom_chain_suppress  # noqa: F401
