// The causal-offset route of the flash kernels (flash_attention.cu: its
// header says what they compute; this file is its OFF = true library),
// built as a library of its own beside flash_attention.cu's, one nvcc each,
// started together. Its C interface is flash_attention_offset_fwd,
// flash_attention_offset_bwd_dq and flash_attention_offset_bwd_dkdv, with
// flash_attention.cu's arguments (kernels/flash_attention.py).
#define FLASH_OFFSET_ROUTE 1
#include "flash_attention.cu"
