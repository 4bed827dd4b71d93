"""xMem ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference ``repro``: the same module
paths and function names, PyTorch inside. It imports torch, numpy and
the standard library only — never JAX and never ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU. The serving path: ``launch.serve.pick_batch`` (the xMem
gate, traced on the CPU) -> ``launch.serve.serve`` (prefill through the
hand-written Hopper flash-attention kernel, then greedy decode) with
``core.baselines.directprobe.measured_peak`` as ground truth.
"""
