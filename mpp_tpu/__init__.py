"""mpp_tpu — a batched multi-physics (land-surface PDE) solver framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the MPP
library (reference at /root/reference): finite-volume systems of governing
equations over control-volume meshes, batched Newton-Krylov and Krylov
solvers, and the MPP problem catalogue (VSFM, thermal, TH, MLC, LBL,
photosynthesis, longwave/shortwave radiation).
"""

__version__ = "0.1.0"
