"""The PyTorch/CUDA port of ``repro`` (see ROADMAP.md).  Imports torch,
numpy and the standard library, never JAX or the ``repro`` package."""
