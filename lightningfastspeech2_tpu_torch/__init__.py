"""PyTorch + CUDA port of ``lightningfastspeech2_tpu`` for one NVIDIA H100.

The JAX package is the reference; this package keeps its subpackage and
module names so each counterpart is easy to find. It imports ``torch``,
numpy and scipy only, never JAX and nothing of the JAX package.

Entry points (``FastSpeech2``, ``Synthesiser``, ``SpeechGenerator``, the
builders) run on ``cuda`` unless the caller passes ``device="cpu"``. On the
card every kernel of the serving path is a hand-written CUDA kernel
(``csrc/``, built with nvcc for ``sm_90a`` at first use); on the CPU the
same wrappers run their plain PyTorch versions.
"""
