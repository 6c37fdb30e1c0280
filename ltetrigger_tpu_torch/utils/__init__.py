"""ltetrigger_tpu/utils, shared with the JAX package by path.

These are the JAX package's own numpy-only files, loaded under this
package's name.  Importing them as `ltetrigger_tpu.utils` would run
ltetrigger_tpu/__init__.py, which imports jax; the port imports none.
"""

import pathlib

__path__ = [str(pathlib.Path(__file__).resolve().parents[2]
                / "ltetrigger_tpu" / "utils")]
