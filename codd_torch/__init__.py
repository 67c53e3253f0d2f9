"""codd_torch — CODD inference, evaluation and training in PyTorch for one
NVIDIA H100.

A port of ``codd_tpu`` (JAX) that computes the same function: HITNet
stereo -> RAFT-3D motion (16 Gauss-Newton iterations, point-splat warping)
-> recurrent fusion, with every motion / fusion variant (the network, the
ground-truth oracles, Kalman, none) and every ``model.runtime`` value
``codd_tpu`` takes.  Entry points, from the top:

* ``python -m codd_torch.tools.inference CONFIG [CHECKPOINT] --eval`` (or
  ``--show-dir``): a dataset's sequences through the model;
* ``python -m codd_torch.tools.bench`` / ``codd_torch.tools.
  benchmark_speed``: the speed benchmarks, in f32 or bf16;
* ``apis.inference.run_inference`` / ``apis.evaluation.
  make_sequence_evaluator``: the same from Python, metrics accumulated on
  the device with one transfer a sequence;
* ``models.builder.build_estimator`` + ``CODD.first_step`` / ``CODD.step``
  (frame by frame) or ``CODD.__call__`` (a clip);
* ``train.trainer.make_train_step`` with ``train.optim.make_optimizer``
  and ``models.builder.build_loss_config``: the training step of the
  stereo stage and of the fusion stage (``losses/``).

Not ported yet: training RAFT-3D (the motion stage; a trainable one
raises), the training entry point, its augmentations and checkpoints.

Conventions:

* **Layout.**  Every public function and module takes and returns NHWC
  tensors, exactly like ``codd_tpu``, so parity tests compare like with
  like.  Convolutions permute to an NCHW *view* internally; a contiguous
  NHWC tensor permuted that way is a channels-last NCHW tensor, which
  cuDNN consumes without a copy.
* **Device.**  ``models.builder.build_estimator`` puts the model on
  ``"cuda"`` and raises when CUDA is missing unless the caller passes
  ``device="cpu"`` (the tests do).  There is no silent CPU fallback.
* **Kernels.**  Six hot ops run hand-written CUDA kernels for
  ``sm_90a`` (``csrc/``): the stereo tile-warp cost
  (``ops/tile_warp.py``), the corr-volume window lookup and the corr
  patch lookup (``ops/corr.py``), the fused GN aggregate + 6x6 solve and
  the GN window aggregate alone (``ops/gn.py``), and the splat
  compositor (``ops/splat.py``); the tile-warp cost also has a backward
  kernel.  Each wrapper runs its plain PyTorch version for CPU tensors
  and launches its kernel (or raises) for CUDA tensors, and a kernel
  without a backward raises where autograd would need its gradient;
  ``ops/kernels.py`` builds the kernels with ``nvcc`` on first use and
  counts launches.
* **Precision.**  Everything is float32 except the bf16 correlation
  features and volumes (and, with ``gn_bf16_scores``, the GN scores and
  their VJP's roundings, in inference and in training, wherever
  ``codd_tpu`` scores in bf16: its windowed form), as in ``codd_tpu``.  A model cast to bf16 with ``utils.precision.
  cast_floats`` and fed bf16 frames computes as ``codd_tpu`` under
  ``bench.py --bf16``: compute follows the dtypes (convolutions promote
  like flax's), f32 is kept for the SE(3) math, the GN system and solve,
  the splat and the correlation products, and every carry and output
  leaf takes ``codd_tpu``'s dtype.  ``build_estimator`` turns TF32 off for
  cuDNN convolutions and cuBLAS matmuls
  (``torch.backends.cudnn.allow_tf32 = False``,
  ``torch.backends.cuda.matmul.allow_tf32 = False``): reduced-precision
  products break the norm cancellation in the GN attention logits.

This package imports ``torch`` and ``numpy`` only — never JAX, flax or
``codd_tpu``.
"""
