"""wav2vecsegmenter_tpu — speech segmentation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
ahclab/Wav2VecSegmenter (wav2vec 2.0 segmentation-frame-classifier training,
sliding-window inference, pDAC/pSTRM/pTHR segmentation algorithms, and the
downstream speech-translation evaluation harness), designed for device
meshes rather than ported from the PyTorch reference.  The package name is
historical; the production target is the GPU.
"""

__version__ = "0.1.0"
