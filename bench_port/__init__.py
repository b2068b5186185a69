"""The benchmark of the PyTorch and CUDA port (``mppi_gpu_tpu_torch``):
``python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one GPU."""
