# Frozen copy of ltetrigger_tpu_torch/ltecore/constants.py (commit ce2615c) for the
# benchmark's generator and reference: later changes to the program do not
# change the yardstick.
"""Frame geometry and LTE cell-search constants.

Accelerator-side re-expression of the reference's compile-time constants
(reference: lib/pss_impl.h:52-55, lib/sss_impl.h:44-48) and of the srsLTE
"standard symbol size" convention (srslte_use_standard_symbol_size(true),
reference lib/pss_impl.cc:69): all sensing runs at 1.92 Msps with a 128-point
OFDM symbol, regardless of the cell's true bandwidth.

Everything here is a Python int / numpy constant.
"""

# --- Sample-rate / frame geometry at the sensing rate (1.92 Msps) ---
SAMPLE_RATE = 1_920_000            # required input rate (reference: cell_search_file.py:30)
SYMBOL_SZ = 128                    # FFT size of one OFDM symbol
SLOT_LENGTH = 960                  # 0.5 ms slot
SUBFRAME_LENGTH = 2 * SLOT_LENGTH  # 1 ms subframe (1920)
HALF_FRAME_LENGTH = 10 * SLOT_LENGTH   # 5 ms (9600) -- the streaming unit
FULL_FRAME_LENGTH = 20 * SLOT_LENGTH   # 10 ms radio frame (19200)

# --- Cyclic prefix lengths at symbol_sz=128 (scaled from 2048-pt 3GPP values) ---
CP_NORM_0 = 10          # first symbol of a slot, normal CP (160/16)
CP_NORM = 9             # other symbols, normal CP (144/16)
CP_EXT = 32             # extended CP (512/16)
SYMBOLS_PER_SLOT_NORM = 7
SYMBOLS_PER_SLOT_EXT = 6

# --- Synchronization signals ---
PSS_LEN = 62            # occupied ZC subcarriers
SSS_LEN = 62
N_ID_2_COUNT = 3        # PSS roots / sector ids
N_ID_1_COUNT = 168      # SSS group ids
PSS_ZC_ROOTS = (25, 29, 34)   # root for N_id_2 = 0, 1, 2 (3GPP 36.211 6.11.1.1)

# PSS occupies the last symbol of slot 0 (subframe 0 and 5); in a peak-aligned
# half-frame the 128 PSS samples (CP stripped) live at [832, 960).
PSS_SYMBOL_START = SLOT_LENGTH - SYMBOL_SZ   # 832
PSS_END = SLOT_LENGTH                        # 960

# --- Trigger state machine defaults (reference: include/ltetrigger/pss.h:68-69,
#     python/downlink_trigger_c.py:10, examples/cell_search_file.py:191-193) ---
DEFAULT_TRACK_AFTER = 16    # half-frames over threshold before "tracking"
DEFAULT_TRACK_EVERY = 8     # while tracking, re-correlate every N half-frames
DEFAULT_PSR_THRESHOLD = 4.0
MIN_PSR_THRESHOLD = 1.5
MOVING_AVG_SZ = 200         # psr/cfo telemetry ring size (reference: lib/pss_impl.h:31)
PSR_EMA_ALPHA = 0.2         # exponential averaging of correlation magnitude across
                            # half-frames (srsLTE pss ema_alpha equivalent)

# --- MIB / PBCH ---
MIB_NOF_PRB = 6             # PBCH always decoded at 6 PRB (SRSLTE_UE_MIB_NOF_PRB)
PBCH_SUBCARRIERS = 72       # 6 PRB * 12
MIB_PAYLOAD_BITS = 24
CRC_BITS = 16
CODED_BITS = 3 * (MIB_PAYLOAD_BITS + CRC_BITS)   # 120 (rate-1/3 conv code)
PBCH_BITS_PER_FRAME_NORM = 480    # QPSK bits carried per radio frame, normal CP
PBCH_BITS_PER_FRAME_EXT = 432     # extended CP (216 REs)
PBCH_TTI_FRAMES = 4               # 40 ms PBCH TTI
NOF_PRB_TABLE = (6, 15, 25, 50, 75, 100)   # MIB bandwidth field -> nof_prb

# Supported integer decimation ratios into the sensing rate
# (reference: examples/cell_search_file.py:50-57 -- only integer ratios)
SUPPORTED_RATES = (1_920_000, 7_680_000, 15_360_000, 30_720_000)


def cp_len(symbol_index_in_slot: int, normal_cp: bool) -> int:
    """CP length of a given symbol within a slot."""
    if not normal_cp:
        return CP_EXT
    return CP_NORM_0 if symbol_index_in_slot == 0 else CP_NORM


def symbol_data_offsets(normal_cp: bool):
    """Start offset of each symbol's 128 data samples within a 960-sample slot."""
    nsym = SYMBOLS_PER_SLOT_NORM if normal_cp else SYMBOLS_PER_SLOT_EXT
    offs = []
    pos = 0
    for l in range(nsym):
        c = cp_len(l, normal_cp)
        offs.append(pos + c)
        pos += c + SYMBOL_SZ
    assert pos == SLOT_LENGTH
    return offs
