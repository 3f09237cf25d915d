"""PyTorch/CUDA port of the PARS serving stack, beside the JAX package.

Subpackages mirror ``repro``: ``configs``, ``core.scheduler``,
``core.predictor``, ``models``, ``kernels``, ``serving``, ``data`` and
``launch``. The port imports ``torch`` and ``numpy`` and never ``jax`` or
``repro``: modules that need no framework are kept as copies of their
reference (``tests/test_torch_boundary.py`` holds them equal). Entry points
run on the card (``device="cuda"``) and raise when CUDA is unavailable; only
an explicit ``device="cpu"`` runs on the CPU, where every kernel wrapper
takes its plain PyTorch version.
"""
