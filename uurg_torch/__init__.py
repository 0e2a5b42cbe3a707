"""PyTorch / CUDA port of the uurg_tpu framework for NVIDIA Hopper (H100).

Module paths mirror ``uurg_tpu``; each module names its JAX counterpart.
The package imports ``torch`` and never ``jax`` or ``uurg_tpu``. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
