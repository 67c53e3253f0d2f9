"""codd_torch — the CODD streaming cascade in PyTorch for one NVIDIA H100.

A port of ``codd_tpu`` (JAX) that computes the same function with the
default runtime knobs: HITNet stereo -> RAFT-3D motion (16 Gauss-Newton
iterations, point-splat warping) -> recurrent fusion, driven frame by
frame through ``CODD.first_step`` / ``CODD.step``.  Only the eval /
inference path exists in this package.

Conventions:

* **Layout.**  Every public function and module takes and returns NHWC
  tensors, exactly like ``codd_tpu``, so parity tests compare like with
  like.  Convolutions permute to an NCHW *view* internally; a contiguous
  NHWC tensor permuted that way is a channels-last NCHW tensor, which
  cuDNN consumes without a copy.
* **Device.**  ``models.builder.build_estimator`` puts the model on
  ``"cuda"`` and raises when CUDA is missing unless the caller passes
  ``device="cpu"`` (the tests do).  There is no silent CPU fallback.
* **Kernels.**  Four hot ops run hand-written CUDA kernels for
  ``sm_90a`` (``csrc/``): the stereo tile-warp cost
  (``ops/tile_warp.py``), the corr-volume window lookup (``ops/corr.py``),
  the fused GN aggregate + 6x6 solve (``ops/gn.py``) and the splat
  compositor (``ops/splat.py``).  Each wrapper runs its plain PyTorch
  version for CPU tensors and launches its kernel (or raises) for CUDA
  tensors; ``ops/kernels.py`` builds the kernels with ``nvcc`` on first
  use and counts launches.
* **Precision.**  Everything is float32 except the bf16 correlation
  volumes, as in ``codd_tpu``.  ``build_estimator`` turns TF32 off for
  cuDNN convolutions and cuBLAS matmuls
  (``torch.backends.cudnn.allow_tf32 = False``,
  ``torch.backends.cuda.matmul.allow_tf32 = False``): reduced-precision
  products break the norm cancellation in the GN attention logits.

This package imports ``torch`` and ``numpy`` only — never JAX, flax or
``codd_tpu``.
"""
