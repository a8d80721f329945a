"""Format constants of the .lnn bitstream.

These mirror the public format constants of the LINNE codec
(reference: include/linne.h:7-19, libs/linne_internal/include/linne_internal.h:8-35).
They are part of the wire format, not implementation choices.
"""

FORMAT_VERSION = 1
CODEC_VERSION = 2
HEADER_SIZE = 30
MAX_NUM_CHANNELS = 8
NUM_PARAMETER_PRESETS = 8

BLOCK_SYNC_CODE = 0xFFFF

# Fixed-point pre-emphasis filter (reference: linne_internal.h:14-16)
PREEMPH_COEF_SHIFT = 5
NUM_PREEMPH_FILTERS = 2

# Coefficient coding (reference: linne_internal.h:18-22)
LPC_COEF_BITWIDTH = 8
LOG2_NUM_UNITS_BITWIDTH = 3
RSHIFT_BITWIDTH = 4

# Block-type decision threshold (reference: linne_internal.h:24)
ESTIMATED_CODELENGTH_THRESHOLD = 0.95

# Unit-count search uses 0 auxiliary-function iterations
# (reference: linne_internal.h:26)
NUM_AF_ITERATIONS_DETERMINE_UNIT = 0

# Gradient-training hyperparameters (reference: linne_internal.h:29-33).
# Note the reference defines the learning rate / epsilon as float literals
# (0.1f, 1e-7 promoted from float), so we store the exact float32-rounded
# values the C code passes to the trainer.
TRAINING_MAX_NUM_ITERATIONS = 2000
TRAINING_LEARNING_RATE = float.fromhex("0x1.99999ap-4")  # (double)0.1f
TRAINING_LOSS_EPSILON = 1.0e-7

# Residual coder (reference: libs/linne_coder/src/linne_coder.c:13-15)
LOG2_MAX_NUM_PARTITIONS = 10
MAX_NUM_PARTITIONS = 1 << LOG2_MAX_NUM_PARTITIONS
RICE_PARAMETER_BITS = 5

# Block data types (reference: linne_internal.h:50-55)
BLOCK_TYPE_COMPRESS = 0
BLOCK_TYPE_SILENT = 1
BLOCK_TYPE_RAW = 2

# Channel processing methods (reference: include/linne.h:34-38)
CH_PROCESS_NONE = 0
CH_PROCESS_MS = 1

# Magic signature of the .lnn container.
MAGIC = b"IBRA"

FLT_EPSILON = float.fromhex("0x1p-23")  # 1.1920928955078125e-07
FLT_MAX = float.fromhex("0x1.fffffep+127")
