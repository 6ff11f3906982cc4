"""vitef_tpu_torch — the PyTorch/CUDA port of ``vitef_tpu`` for NVIDIA Hopper.

The JAX package ``vitef_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``. Every Pallas kernel of ``vitef_tpu`` on a ported path becomes a
CUDA kernel written by hand for ``sm_90a`` (``ops/csrc/``), built with ``nvcc``
at first use and bound with ``ctypes`` (``ops/_build.py``).

Ported so far: ViT-B/16 inference (``models.build_model`` →
``eval.run_evaluation``), finetuning (``parallel.make_train_step``) and the
paper's read-outs (``Model.get_decomposition``/``get_probes``,
``apps.vit.analysis``, ``apps.vit.linear_probing``, ``probe``), GPT-2,
Llama and MoE causal-LM training with the fused head + CE loss
(``ops.make_fused_head_loss``), and serving (``Model.generate``,
``models.serving.DecodeServer``, ``apps.gpt2.sample``/``serve``), through
the packed attention kernels K1 (forward, causal or not, with or without
the serving prefill's key mask), K2 and K3 (backward), the flash attention kernels
K4 (forward, bfloat16 or float32) and K5 (backward), the LayerNorm K6
(forward and dx, ``norm_impl="kernel"``), the grouped products K7 and K8,
and the train augment K10.
"""

__version__ = "0.1.0"
