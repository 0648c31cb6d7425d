"""amos_slam_tpu_torch: the PyTorch/CUDA port of amos_slam_tpu.

The JAX package ``amos_slam_tpu`` is the reference; this package mirrors its
module paths and public names so a reader can find each counterpart. It
imports neither jax nor ``amos_slam_tpu``. Plain tensor code is PyTorch; the
JAX package's Pallas kernels are hand-written CUDA kernels under ``csrc/``,
built with nvcc at first use (``ops/kernels/``). Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.

Subpackages
-----------
geometry   SE3 and Sim3 Lie groups, pinhole camera.
solvers    Robust weights, pose optimization, local BA, PnP, F-RANSAC, the
           two-view H/F initializer, Sim3 RANSAC and refinement, pose graph,
           structure-only refits.
ops        Pyramid, FAST-9, rBRIEF, Hamming and stereo matching; kernels/
           holds the CUDA kernel wrappers.
frontend   ORB extraction pipeline, tracking, the geometric dynamic stage.
slam_map   Map state, local-map tracking, triangulation, maintenance.
loop       BoW vocabulary, keyframe database, loop closing, relocalization,
           global BA (data/default_vocab.npz is the default vocabulary).
models     YOLACT stage one: ResNet-FPN, ProtoNet, fast-NMS, Segmenter;
           its training (configs, data, multibox loss, SGD step) and mAP.
io         Synthetic scenes, TUM / KITTI / EuRoC loaders, trajectory IO,
           ATE/RPE evaluation.
parallel   Multistream SLAM over a stream mesh; the data-parallel YOLACT
           train step over a process group.
utils      Trace annotations, a trace context manager, a host span timer.
examples   The reference's six example mains against the port.
tools      Timing tools for the card.
system     The System facade (RGB-D per frame and chunked, stereo, mono).
"""

import torch as _torch

__version__ = "0.1.0"

# Exact f32 everywhere, the counterpart of amos_slam_tpu/__init__.py pinning
# jax_default_matmul_precision=highest. The pose chain (velocity @ Tcw, point
# transforms, the 6x6 normal equations) runs through small f32 products;
# reduced-precision f32 (TF32 on this card, bf16 on the TPU) made the JAX
# tracker diverge to meter-level ATE while the exact run held millimetres.
# Ops that want reduced precision (the bf16 descriptor sampler) cast
# explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
