"""Command-line tools around a map, ported from the JAX package's
``scripts/`` and ``examples/``: each is run as ``python -m
f2nerf_tpu_torch.tools.<name>`` with the script's positional arguments,
flags, defaults and output files, and imports only torch, numpy and the
port (no ``jax``, ``yaml`` or ``PIL``). The tools that run the model take
``--device`` (default: the card; ``cpu`` runs the plain PyTorch path).
"""
