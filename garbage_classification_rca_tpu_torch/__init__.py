"""PyTorch + CUDA port of the garbage-classification framework.

A second package beside the JAX one (``garbage_classification_rca_tpu``),
held against it by the tests. It runs, end to end on an NVIDIA H100:

  * the headline MM-RCA multimodal evaluation and training
    (``cli/test_both.py``, ``cli/main_both.py``): EfficientNetV2-M image
    tower (cuDNN convolutions, BatchNorm folded for eval), 6-layer
    DistilBERT text tower on the hand-written attention kernels
    (``kernels/mha_fused.py``), the MM-RCA fusion block as hand-written
    CUDA kernels (``kernels/rca_fused.py``);
  * the unimodal evaluations (``cli/test_text.py``: DistilBERT, BERT,
    RoBERTa; ``cli/test_image.py``: ViT-B/16, ViT-L/16), whose encoder
    layers are the hand-written fused transformer blocks
    (``kernels/transformer_block.py``);
  * the test CLIs writing the reference report CSV + confusion PNG.

The package imports torch, never jax, and nothing of the JAX package: the
host modules it needs (config, data, report, checkpoint loading) are its
own copies. Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, or ``GC_RCA_PLATFORM=cpu`` for the CLI); without CUDA
and without that request they raise.
"""

__version__ = "0.1.0"

CLASSES = ("black", "blue", "green", "ttr")
NUM_CLASSES = len(CLASSES)
CLASS_DISPLAY_NAMES = ("Black", "Blue", "Green", "TTR")
