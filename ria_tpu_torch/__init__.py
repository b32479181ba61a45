"""ria_tpu_torch: the PyTorch/CUDA port of ria_tpu for NVIDIA Hopper.

Mirrors the layout of ``ria_tpu`` (utils, fec, dsp, sync, wave, phy).  Plain tensor
code is PyTorch; the LDPC belief-propagation kernel is CUDA C++ compiled for
sm_90a on first use (``csrc/ldpc_bp.cu``).  Imports no JAX.
"""
