"""The benchmark of the PyTorch/CUDA port ``dt4image_restoration_tpu_torch``.

Run from the root of a checkout as ``python3 -m portbench --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` (:mod:`portbench.run`); the cells
are the ``workloads`` of ``BENCHMARK.json``. It measures the port only, and
neither it nor anything it loads imports JAX or the JAX package.
"""
