"""PyTorch + CUDA port of the garbage-classification framework.

A second package beside the JAX one (``garbage_classification_rca_tpu``),
held against it by the tests. This slice runs the headline MM-RCA
multimodal evaluation end to end on an NVIDIA H100:

  * EfficientNetV2-M image tower (cuDNN convolutions, BatchNorm folded),
  * 6-layer DistilBERT text tower whose attention runs the hand-written
    masked multi-head attention kernel (``kernels/mha_fused.py``),
  * the MM-RCA fusion block as one hand-written CUDA kernel
    (``kernels/rca_fused.py``),
  * the test CLI writing the reference report CSV + confusion PNG.

The package imports torch, never jax, and nothing of the JAX package: the
host modules it needs (config, data, report, checkpoint loading) are its
own copies. Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, or ``GC_RCA_PLATFORM=cpu`` for the CLI); without CUDA
and without that request they raise.
"""

__version__ = "0.1.0"

CLASSES = ("black", "blue", "green", "ttr")
CLASS_DISPLAY_NAMES = ("Black", "Blue", "Green", "TTR")
