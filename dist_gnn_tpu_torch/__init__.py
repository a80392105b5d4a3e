"""dist_gnn_tpu_torch — the PyTorch/CUDA port of ``dist_gnn_tpu``.

A second package beside the JAX one, which stays the numerical reference.
Module names and public signatures follow ``dist_gnn_tpu`` so each
counterpart is easy to find; inside, the code is PyTorch: explicit
devices, ``torch.Generator`` in place of ``jax.random`` keys, and
``nn.Module`` models.  The Pallas kernels on the ported path are CUDA C++
kernels for Hopper (``csrc/``), each with a plain PyTorch version that
serves CPU tensors only.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card they raise, they never fall back
(:func:`dist_gnn_tpu_torch.utils.device.resolve_device`).

Ported so far: the sampler, K1 feature gather, SAGE with the K3
neighbour mean (forward and backward kernels), GAT with the fused
attention kernels K4 (forward) and K5 (backward), ``Trainer.train_step``
(Adam with coupled L2, dropout), ``Trainer.eval_step`` and SAGE
full-graph inference.
"""

from dist_gnn_tpu_torch.graph import INVALID_ID, Graph, HostGraph  # noqa: F401

__version__ = "0.1.0"
