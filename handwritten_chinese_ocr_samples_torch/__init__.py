"""handwritten_chinese_ocr_samples_torch — the PyTorch/CUDA port of the HCTR
recognizer for NVIDIA Hopper.

A second package beside the JAX reference (``handwritten_chinese_ocr_samples_tpu``),
with the same module names. It imports ``torch`` and numpy only; the CUDA
kernels under ``csrc/`` are built with ``nvcc`` at first use (``ops/_build.py``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
