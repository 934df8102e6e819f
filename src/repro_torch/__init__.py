"""LA-IMR on PyTorch and CUDA: the port of the JAX package ``repro``.

Same sub-package layout as the reference (``core``, ``control``,
``configs``, ``models``, ``kernels``, ``serving``), so every ported
module has an obvious twin.
It imports ``torch`` and ``numpy``, never ``jax`` or ``repro``. Its
entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""
