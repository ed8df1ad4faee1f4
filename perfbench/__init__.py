"""The benchmark of the PyTorch and CUDA port (``detection_3d_tpu_torch``):
one cell a run, ``python3 -m perfbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout on a machine
with an NVIDIA card. It never imports JAX or the JAX package."""
