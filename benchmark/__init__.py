"""The benchmark of the PyTorch/CUDA port (``amos_slam_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic in ``traffic/``, its driver in
``drivers/``, its correctness limits in ``checks/`` and each per-layer
metric's reader in ``metrics/``. Nothing here imports JAX or the JAX
package; the references under ``reference/`` import nothing of the port.
"""
