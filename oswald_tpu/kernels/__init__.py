from oswald_tpu.kernels.sw_lanes import (
    sw_chunk, build_profile, noadj_ok, kernel_interpret, CHUNK_WIDTH,
    POS_PER_CHUNK,
)

__all__ = ["sw_chunk", "build_profile", "noadj_ok", "kernel_interpret",
           "CHUNK_WIDTH", "POS_PER_CHUNK"]
