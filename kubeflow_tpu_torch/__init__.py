"""PyTorch/CUDA port of kubeflow_tpu's data plane, for NVIDIA Hopper.

The JAX package (``kubeflow_tpu``) stays the reference; this package
mirrors its module paths and names so every module has an obvious
counterpart, and imports nothing from it (pure-Python modules it needs
are kept here as copies). Plain tensor code is PyTorch; every TPU kernel
on a ported path is a kernel written by hand for ``sm_90a`` under
``csrc/``.

Slices ported so far:

- serving: ``python -m kubeflow_tpu_torch.serving.runtime`` (the
  ``kubeflow_tpu.serving.runtime`` env contract) over the continuous-
  batching ``serving.llm.LLMEngine``, whose paged decode attention is the
  CUDA kernel ``csrc/paged_decode_attention.cu``.
  Quantized (int8/fp8 KV, int8 weights) through the same kernel
  source's fused-dequant entry; over a serving mesh
  (``KFT_MESH=expert=E,tensor=T``, ``parallel.TensorMesh``) with one
  process per rank, each decoding its own KV heads through the same
  kernels (MoE experts cut over ``expert``), disaggregated tiers
  included.
- training: ``training.Trainer`` / ``training.loop.fit`` on one card
  (the ``kubeflow_tpu.training`` contract minus checkpoints), whose
  ``attn_impl="pallas"``/``"flash"`` attention is the CUDA kernels
  ``csrc/flash_attention_{fwd,dq,dkv}.cu`` under an autograd Function.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, or ``KFT_FORCE_PLATFORM=cpu`` for the runtime); with
no GPU and no such request they raise (``device.resolve_device``).
"""
