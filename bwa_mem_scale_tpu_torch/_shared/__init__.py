"""JAX-free host modules of ``bwa_mem_scale_tpu``, imported without
running that package's ``__init__`` (which imports jax).

This package's ``__path__`` points at the JAX package's directory, so
``bwa_mem_scale_tpu_torch._shared.index.artifacts`` is the very file
``bwa_mem_scale_tpu/index/artifacts.py``, loaded as a submodule of this
package; its relative imports resolve inside ``_shared`` too.

Import through here only modules that contain no JAX: ``index/*``,
``io/*``, ``ref/*``, ``config``, ``utils/profiling``, ``utils/npzmap``,
``pipeline/native_finalize``, ``pipeline/native_kswg``, ``pipeline/pe``
for its ``PeStat`` only (its ``run_rescue_jobs`` reaches ``ops.kswa``,
which is JAX, when the native kswa library is missing) and the option
parsers of ``cli`` (``_add_mem_opts``, ``_opts_from_args``). Never
``ops/*``, ``models/*``, ``store`` or the other ``pipeline`` modules
(``pipeline/pe_batch`` imports ``pipeline/finalize``, which is JAX):
those depend on JAX.
"""

import os

__path__ = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "bwa_mem_scale_tpu")]

# cli.py reads the package version at import
__version__ = "0.1.0"
