# Frozen copy of ltetrigger_tpu_torch/ltecore/__init__.py (commit ce2615c) for the
# benchmark's generator and reference: later changes to the program do not
# change the yardstick.
"""ltecore: pure LTE signal-model math (numpy constants + host reference impls).

This layer owns every sequence, table, and bit-format the sensing chain needs:
PSS Zadoff-Chu replicas, SSS m-sequences and (m0,m1)->N_id_1 maps, Gold
scrambling generator matrices, CRS pilots, CRC-16, the tail-biting
convolutional code with its trellis tables, PBCH rate matching, and MIB
packing.  It is the first-party replacement for the srsLTE primitives the
reference links against (SURVEY.md §2.2b).

Everything is numpy / python ints — exhaustively unit-testable, and consumed
by the ops layer as static constants.

The port's own copy of ltetrigger_tpu/ltecore (same module names);
tests/test_torch_shared.py holds every table and function equal to the
JAX package's.
"""

from . import constants, pss, sss, scrambling, coding, mib, crs  # noqa: F401
