"""Device-side ops on torch tensors: box math, fixed-capacity NMS, exact
adaptive-average pooling, distance Gram matrices, K-means and cluster
scores, and the hand-written CUDA kernels with their plain PyTorch versions
(``pnet_kernel``, ``crops_kernel``, ``resize_kernel``; built by ``_cuda``).

Dynamic-size results (filtering, NMS, selection) are fixed-capacity padded
buffers plus validity masks, as in the JAX package.
"""
