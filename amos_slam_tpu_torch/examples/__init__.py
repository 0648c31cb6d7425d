"""The reference's example mains against the port: run each as
``python3 -m amos_slam_tpu_torch.examples.<name> ...`` (``--help`` lists its
arguments). They track on the CUDA card unless ``--device cpu`` is given."""
