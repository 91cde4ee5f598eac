"""Device-side ops on torch tensors: box math, fixed-capacity NMS, exact
adaptive-average pooling, distance Gram matrices, K-means and cluster
scores, and the hand-written CUDA kernels with their plain PyTorch versions
(``pnet_kernel``, ``crops_kernel``, ``resize_kernel``, ``roi_align_kernel``;
built by ``_cuda``), anchors, the R-CNN preprocess resize and multilevel
RoIAlign.

Dynamic-size results (filtering, NMS, selection) are fixed-capacity padded
buffers plus validity masks, as in the JAX package.
"""
