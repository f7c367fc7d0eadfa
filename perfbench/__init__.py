"""The benchmark of the PyTorch and CUDA port (``cglb_tpu_torch``).

``run.py`` is its command; ``README.md`` says how to run it, how to add a
configuration, a traffic mix, a cell or a metric, and how to test it.
"""
