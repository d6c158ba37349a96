"""repro_torch: the PyTorch/CUDA port of ``repro``.

The same dynamic parallel method (measure -> EMA -> proportional split) and
the same compiled balanced decode path, with PyTorch for the tensor code
and hand-written CUDA kernels for Hopper (sm_90a) in place of the Pallas
TPU kernels.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU; on CPU tensors every kernel wrapper takes its
plain PyTorch version.
"""

__version__ = "0.1.0"
