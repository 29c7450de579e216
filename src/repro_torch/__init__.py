"""PyTorch/CUDA port of the 2GTI guided sparse retrieval system.

A second package beside the JAX reference ``repro``, with the same layout
and names: ``repro_torch.core.plan`` is the counterpart of
``repro.core.plan``, and so on. It imports torch and numpy only. The
entry points (``core.build_index``, ``retrieval.Retriever.open``) place
their tensors on ``device="cuda"`` unless the caller passes
``device="cpu"``; the hot loop runs through the hand-written Hopper
kernels in ``kernels/`` on CUDA tensors and through their plain PyTorch
versions on CPU tensors.
"""
