"""Twins of the JAX package's ``examples/``, run as modules:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--small] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.dvfs_sim
    PYTHONPATH=src python -m repro_torch.examples.heat_distributed
    PYTHONPATH=src python -m repro_torch.examples.interference_sim
    PYTHONPATH=src python -m repro_torch.examples.kmeans

Each does what its original does, with the same configs, seeds, step
counts and printed lines.  The model examples run on the card unless
``--device cpu`` is given; the simulator examples run the copied ``core``
on the host, as their originals do, and print their originals' lines.
Importing a module runs nothing: each has a ``main``.
"""
