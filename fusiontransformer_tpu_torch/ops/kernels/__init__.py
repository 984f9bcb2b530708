"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper runs the plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device (or raises); there is no
fallback between the two.  ``LAUNCHES[name]`` counts the kernel launches of
each wrapper, and only those, so a run can show that its path went through
the kernels.
"""

from collections import Counter

LAUNCHES = Counter()


def reset_launches():
    LAUNCHES.clear()
