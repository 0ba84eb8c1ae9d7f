"""apde_mvs_tpu_torch — the PyTorch / CUDA port of apde_mvs_tpu for one
NVIDIA H100.

It runs round 0 of the coarse-to-fine schedule end to end: one FIRST_INIT
pass and three REFINE_ITER geometric passes per view (no APD weak path),
then fusion into a PLY. Plain tensor code is PyTorch; the one kernel that the
JAX package wrote in Pallas, the bilinear sampler, is a hand-written CUDA
kernel (``ops/cuda/sampler.py`` + ``csrc/sampler.cu``) that every NCC
evaluation of the pass samples through.

The package mirrors the layout of ``apde_mvs_tpu`` so each module's
counterpart is found under the same name; it imports nothing of it (nor of
JAX) and keeps its own copies of the JAX-free host modules.

- ``cli``       per-scan engine CLI (APD parity, plus ``--device``)
- ``pipeline``  scan driver, per-view PatchMatch pass, fusion
- ``ops``       cost, propagation, selection, filters; ``ops/cuda`` kernels
- ``core``      device binding, camera geometry, sampling, checkerboard
- ``io``        bin-mat / camera / pair / PLY / image codecs
"""

__version__ = "0.1.0"
