"""Shared compute-plane constants.

``BIG`` is the effectively-infinite f32 distance used by every SPF kernel
and its plain PyTorch version: a plain Python float, exactly representable
in f32, so the CUDA kernels, the plain versions and the JAX reference
agree bit for bit.  ``BIG + BIG`` overflows to ``+inf`` in f32; the
kernels rely on IEEE min/compare treating that inf exactly, which is why
they are never built with fast math.
"""

import numpy as np

#: effectively-infinite distance, exactly representable in f32
BIG = float(np.float32(3.4e38))
