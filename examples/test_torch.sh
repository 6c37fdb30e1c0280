#!/bin/bash
# Smoke test of the PyTorch port's CLI over the four bundled captures (the
# port's counterpart of examples/test.sh).
#   FRAMES=DIR [DEVICE=cuda] examples/test_torch.sh
# FRAMES names the directory of the captures; DEVICE defaults to cuda (the
# CLI raises where there is no card).
set -e
FRAMES=${FRAMES:?set FRAMES to the directory holding the four captures}
DEVICE=${DEVICE:-cuda}
cd "$(dirname "$0")/.."
run() { python -m ltetrigger_tpu_torch.apps.cell_search_file "$@" --repeat --time-out 1 --device "$DEVICE"; }
run "$FRAMES/lte_frame_6prb_cellid_123"   -s 1.92M
run "$FRAMES/lte_frame_25prb_cellid_124"  -s 7.68M
run "$FRAMES/lte_frame_50prb_cellid_125"  -s 15.36M
run "$FRAMES/lte_frame_100prb_cellid_369" -s 30.72M
