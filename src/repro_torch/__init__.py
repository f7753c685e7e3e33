"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

It imports nothing of the JAX package: the modules it needs from there
without change (the scheduler core, the configs, the batching and overload
policies) are copies, held to their originals by
``tests/test_torch_isolation.py``.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
