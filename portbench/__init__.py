"""portbench: the benchmark of ``vszip_tpu_torch``, the PyTorch and CUDA port,
on NVIDIA H100 cards.  ``run.py`` is the command; ``BENCHMARK.json`` at the
root of the checkout names the cells, configurations and metrics, each found
here by name.  Nothing here imports JAX or the JAX package ``vszip_tpu``."""
