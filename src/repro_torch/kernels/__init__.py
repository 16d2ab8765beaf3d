"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``ops.py`` is the dispatch the models call; ``ref.py`` holds the plain
versions; ``_build.py`` compiles ``csrc/*.cu`` at first use.  Nothing is
compiled or loaded when this package is imported.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
