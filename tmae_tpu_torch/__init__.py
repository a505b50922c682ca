"""PyTorch + CUDA port of tmae_tpu for one NVIDIA H100 (sm_90a).

The JAX package ``tmae_tpu`` is the reference; this package imports nothing of
it. Module names follow the JAX package so each counterpart is easy to find.
Every Pallas kernel on the serving path has a hand-written CUDA kernel under
``csrc/`` with a plain PyTorch version beside its wrapper (see ``device.py``).
"""
