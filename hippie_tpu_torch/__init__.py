"""hippie_tpu_torch — the PyTorch/CUDA port of hippie_tpu, for NVIDIA Hopper.

HIPPIE embeds extracellular action-potential waveforms and ISI distributions
with a conditional VAE (1-D ResNet18 encoder and decoder). ``hippie_tpu`` is
the JAX/TPU package; this package is its port to PyTorch, module for module
at the same paths (``hippie_tpu/models/cvae.py`` ->
``hippie_tpu_torch/models/cvae.py``), held against it by the
``tests/test_torch_*.py`` parity tests.

Every Pallas kernel of ``hippie_tpu`` that the port covers is a hand-written
CUDA kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``). A kernel's wrapper launches it for a CUDA tensor and takes
its plain PyTorch version for a CPU tensor; there is no fallback between the
two. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

The package imports neither ``jax`` nor ``hippie_tpu``.
"""

__version__ = "0.1.0"
